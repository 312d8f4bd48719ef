"""The port's MLP and CNN against the JAX package's, on the CPU.

The JAX package's initial weights move into the port (``w [in, out]`` to
``nn.Linear``'s ``[out, in]``, HWIO convolutions to OIHW); forward and
gradients must match ``torchft_tpu.models.{mlp,cnn}`` within
``atol=rtol=1e-4`` (tests/test_torch_transformer.py's tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchft_tpu.models import cnn as jcnn
from torchft_tpu.models import mlp as jmlp
from torchft_tpu_torch.models import cnn as tcnn
from torchft_tpu_torch.models import mlp as tmlp

TOL = dict(atol=1e-4, rtol=1e-4)


def _load_linear(layer, p):
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(np.asarray(p["w"]).T.copy()))
        layer.bias.copy_(torch.from_numpy(np.asarray(p["b"])))


def _load_conv(conv, p):
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.asarray(p["w"]).transpose(3, 2, 0, 1).copy()))
        conv.bias.copy_(torch.from_numpy(np.asarray(p["b"])))


def _linear_grad(layer):
    return {"w": layer.weight.grad.numpy().T, "b": layer.bias.grad.numpy()}


def _conv_grad(conv):
    return {"w": conv.weight.grad.numpy().transpose(2, 3, 1, 0), "b": conv.bias.grad.numpy()}


def _assert_tree_close(got, want):
    for key in want:
        for leaf in ("w", "b"):
            np.testing.assert_allclose(got[key][leaf], np.asarray(want[key][leaf]), **TOL)


def test_mlp_forward_and_grads_match_jax():
    sizes = (784, 128, 128, 10)
    params = jmlp.init_params(jax.random.PRNGKey(0), sizes)
    x = np.random.default_rng(1).standard_normal((4, 784)).astype(np.float32)
    model = tmlp.MLP(sizes, device="cpu")
    for i in range(3):
        _load_linear(getattr(model, f"layer_{i}"), params[f"layer_{i}"])
    out = tmlp.forward(model, torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jmlp.forward(params, jnp.asarray(x))), **TOL)

    out.square().mean().backward()
    grads = jax.jit(jax.grad(lambda p, a: jnp.mean(jmlp.forward(p, a) ** 2)))(params, jnp.asarray(x))
    _assert_tree_close(
        {f"layer_{i}": _linear_grad(getattr(model, f"layer_{i}")) for i in range(3)}, grads
    )


@pytest.mark.parametrize("n_fragments", [1, 2, 3])
def test_mlp_fragment_keys_match_jax(n_fragments):
    sizes = (8, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 2)  # 11 layers: layer_10 sorts numerically
    model = tmlp.init_params(torch.Generator().manual_seed(0), sizes, device="cpu")
    # the JAX function reads only the top-level keys of its param tree
    want = jmlp.fragment_keys({f"layer_{i}": None for i in range(11)}, n_fragments)
    assert tmlp.fragment_keys(model, n_fragments) == want
    assert tmlp.fragment_keys(dict(model.named_children()), n_fragments) == want


def test_cnn_forward_and_grads_match_jax():
    params = jcnn.init_params(jax.random.PRNGKey(0))
    x = np.random.default_rng(2).standard_normal((2, 32, 32, 3)).astype(np.float32)
    model = tcnn.CNN(device="cpu")
    for name in ("conv1", "conv2"):
        _load_conv(getattr(model, name), params[name])
    for name in ("fc1", "fc2"):
        _load_linear(getattr(model, name), params[name])
    out = tcnn.forward(model, torch.from_numpy(x))
    np.testing.assert_allclose(
        out.detach().numpy(), np.asarray(jax.jit(jcnn.forward)(params, jnp.asarray(x))), **TOL
    )

    out.square().mean().backward()
    grads = jax.jit(jax.grad(lambda p, a: jnp.mean(jcnn.forward(p, a) ** 2)))(params, jnp.asarray(x))
    got = {n: _conv_grad(getattr(model, n)) for n in ("conv1", "conv2")}
    got.update({n: _linear_grad(getattr(model, n)) for n in ("fc1", "fc2")})
    _assert_tree_close(got, grads)


def test_init_matches_jax_statistics():
    # a torch.Generator draws other values than JAX's key; the shapes and
    # distributions must be the JAX package's
    jm = jmlp.init_params(jax.random.PRNGKey(0))
    tm = tmlp.init_params(torch.Generator().manual_seed(0), device="cpu")
    for i in range(3):
        layer = getattr(tm, f"layer_{i}")
        assert layer.weight.shape[::-1] == jm[f"layer_{i}"]["w"].shape
        assert float(layer.bias.detach().abs().sum()) == 0.0
        np.testing.assert_allclose(
            float(layer.weight.std()), float(jnp.std(jm[f"layer_{i}"]["w"])), rtol=0.1
        )
    jc = jcnn.init_params(jax.random.PRNGKey(0))
    tc = tcnn.init_params(torch.Generator().manual_seed(0), device="cpu")
    for name in ("conv1", "conv2", "fc1", "fc2"):
        w = getattr(tc, name).weight
        assert w.numel() == jc[name]["w"].size
        np.testing.assert_allclose(float(w.std()), float(jnp.std(jc[name]["w"])), rtol=0.1)
