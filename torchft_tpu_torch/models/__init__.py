"""Model families: the flagship llama-style transformer."""
