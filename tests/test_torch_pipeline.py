"""The port's pipeline (GPipe over ``pp``) and pipelined transformer against
the JAX package's, on the CPU.

``pipeline_apply`` is held to JAX's for 2 and 4 stages on a stack of
``tanh(x @ w + b)`` layers with a pytree side stream: outputs on every
stage, and the gradients of each stage's layers and of the input.  The
transformer (tiny f32 4-layer config, the JAX package's initial weights
moved in through ``convert.params_from_jax(..., mesh=...)``) runs
``forward_pipelined`` and ``make_grad_step`` on thread ranks forming the
inner mesh; JAX runs ``forward_pipelined`` and ``jax.value_and_grad`` of the
same loss on a mesh of the same shape (its virtual CPU devices).  Tolerance
``atol=5e-5, rtol=1e-4`` (tests/test_torch_hsdp.py's; 1e-4 on logits, as
tests/test_pipeline.py), the MoE loss to 2e-5 relative
(tests/test_moe.py).  Every rank group runs under ``run_ranks``' 60 s
limit, so a stage that waits on a hop nobody sends fails its test instead
of hanging the suite.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from torchft_tpu.models import transformer as jtf
from torchft_tpu.parallel.pipeline import pipeline_apply as j_pipeline_apply
from torchft_tpu_torch import convert
from torchft_tpu_torch.models import transformer as ttf
from torchft_tpu_torch.parallel import multihost, pipeline
from torchft_tpu_torch.parallel.device_mesh import ft_init_device_mesh

TOL = dict(atol=5e-5, rtol=1e-4)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
SHAPE = dict(
    vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
    n_layers=4, max_seq_len=16,
)
MICROBATCHES = 2
#: mesh name -> (shape, attention route, config changes)
MESHES = {
    "pp2": ({"pp": 2}, "dense", {}),
    "pp4": ({"pp": 4}, "dense", {}),
    "dp2-pp2": ({"dp": 2, "pp": 2}, "dense", {}),
    "tp2-pp2": ({"tp": 2, "pp": 2}, "dense", {}),
    "cp2-pp2-ring": ({"cp": 2, "pp": 2}, "ring", {}),
    "cp2-pp2-ulysses": ({"cp": 2, "pp": 2}, "ulysses", {}),
    "ep2-pp2-moe": ({"ep": 2, "pp": 2}, "dense",
                    dict(n_experts=4, d_ff=48, remat=True)),
}


def run_mesh(shape, body):
    n = int(np.prod(list(shape.values())))
    worlds = multihost.local_worlds(n, timeout=30.0)

    def rank(r):
        mesh = ft_init_device_mesh(None, shape, groups=worlds[r], device="cpu").mesh
        return body(r, mesh)

    return multihost.run_ranks(rank, n, timeout=60.0)


def _jax_mesh(shape):
    n = int(np.prod(list(shape.values())))
    return Mesh(np.array(jax.devices()[:n]).reshape(tuple(shape.values())), tuple(shape))


# ---------------------------------------------------------------------------
# pipeline_apply
# ---------------------------------------------------------------------------


def _jax_layer(h, p):
    w, b = p
    y = jnp.tanh(h["x"] @ w + b)
    return {"x": y, "s": h["s"] + (y * y).mean((-2, -1))}


def _port_layer(h, p):
    w, b = p
    y = torch.tanh(h["x"] @ w + b)
    return {"x": y, "s": h["s"] + (y * y).mean((-2, -1))}


def _stack(n_layers, d):
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((n_layers, d, d)) / np.sqrt(d)).astype(np.float32)
    bs = (rng.standard_normal((n_layers, d)) * 0.1).astype(np.float32)
    x = rng.standard_normal((8, 3, d)).astype(np.float32)
    return ws, bs, x


@pytest.mark.parametrize("stages", [2, 4])
def test_pipeline_apply_matches_jax_with_a_side_stream(stages):
    """Outputs on every stage and the gradients of every layer and of the
    input, against JAX's ``pipeline_apply`` and ``jax.grad``; the side
    stream ``s`` rides the pipe beside the activations."""
    ws, bs, x = _stack(8, 12)
    s0 = np.zeros((8,), np.float32)
    mesh = _jax_mesh({"pp": stages})

    def j_loss(params, xx):
        out = j_pipeline_apply(params, {"x": xx, "s": jnp.asarray(s0)}, _jax_layer, mesh,
                               microbatches=4)
        return (out["x"] ** 2).mean() + out["s"].mean(), out

    (j_val, j_out), (j_gp, j_gx) = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1),
                                                             has_aux=True))(
        (jnp.asarray(ws), jnp.asarray(bs)), jnp.asarray(x))

    def body(r, m):
        layers = [(torch.tensor(w, requires_grad=True), torch.tensor(b, requires_grad=True))
                  for w, b in zip(ws, bs)]
        xx = torch.tensor(x, requires_grad=True)
        out = pipeline.pipeline_apply(layers, {"x": xx, "s": torch.from_numpy(s0)},
                                      _port_layer, m, microbatches=4)
        loss = (out["x"] ** 2).mean() + out["s"].mean()
        loss.backward()
        return float(loss.detach()), out, layers, xx.grad

    ranks = run_mesh({"pp": stages}, body)
    per = 8 // stages
    for s, (val, out, layers, gx) in enumerate(ranks):
        np.testing.assert_allclose(val, float(j_val), **TOL)
        for k in ("x", "s"):
            np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(j_out[k]), atol=1e-5)
        # each stage's own layers carry gradients, the others none
        for layer, (w, b) in enumerate(layers):
            if s * per <= layer < (s + 1) * per:
                np.testing.assert_allclose(w.grad.numpy(), np.asarray(j_gp[0][layer]), atol=1e-5)
                np.testing.assert_allclose(b.grad.numpy(), np.asarray(j_gp[1][layer]), atol=1e-5)
            else:
                assert w.grad is None and b.grad is None
        if s == 0:
            np.testing.assert_allclose(gx.numpy(), np.asarray(j_gx), atol=1e-5)
        else:
            assert gx is None or not gx.any()


def test_pipeline_apply_checks_what_jax_checks():
    ws, bs, _ = _stack(4, 8)
    layers = list(zip(torch.from_numpy(ws), torch.from_numpy(bs)))
    x = {"x": torch.zeros(6, 8), "s": torch.zeros(6)}

    def body(r, m):
        with pytest.raises(ValueError, match="not divisible by microbatches"):
            pipeline.pipeline_apply(layers, x, _port_layer, m, microbatches=4)
        with pytest.raises(ValueError, match="mesh has no 'dp' axis"):
            pipeline.pipeline_apply(layers, x, _port_layer, m, axis_name="dp")
        return True

    assert run_mesh({"pp": 2}, body) == [True, True]

    def body8(r, m):
        with pytest.raises(ValueError, match="not divisible by pp"):
            pipeline.pipeline_apply(layers, x, _port_layer, m, microbatches=2)
        return True

    assert all(run_mesh({"pp": 8}, body8))


# ---------------------------------------------------------------------------
# forward_pipelined
# ---------------------------------------------------------------------------


def _configs(attn_impl, **kw):
    shape = dict(SHAPE, **{k: v for k, v in kw.items() if k in SHAPE})
    extra = {k: v for k, v in kw.items() if k not in SHAPE}
    extra.setdefault("remat", False)
    return (
        jtf.TransformerConfig(dtype=jnp.float32, attn_impl=attn_impl, **shape, **extra),
        ttf.TransformerConfig(dtype=torch.float32, attn_impl=attn_impl, **shape, **extra),
    )


@functools.lru_cache(maxsize=None)
def _setup(n_experts=0):
    jcfg, _ = _configs("dense", n_experts=n_experts, d_ff=48 if n_experts else 64)
    params = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    tokens = np.random.default_rng(1).integers(0, 64, (4, 16)).astype(np.int32)
    return params, tree, tokens


def _jax_step(jcfg, params, tokens, shape):
    mesh = _jax_mesh(shape)
    if "tp" in shape:
        params = jtf.shard_params(params, mesh, jcfg)
    tok = jnp.asarray(tokens)

    def loss(p):
        logits, aux = jtf.forward_pipelined(p, tok, jcfg, mesh, microbatches=MICROBATCHES,
                                            return_aux=True)
        lse = jax.nn.logsumexp(logits[:, :-1], axis=-1)
        picked = jnp.take_along_axis(logits[:, :-1], tok[:, 1:, None], axis=-1)[..., 0]
        return (lse - picked).mean() + jcfg.moe_aux_weight * aux, (logits, aux)

    (val, (logits, aux)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return float(val), np.asarray(logits), float(aux), grads


def _rank_rows(mesh, b):
    """The group's rows this rank holds under the pipeline: its block of
    each microbatch (forward_pipelined's docstring)."""
    block, blocks = 0, 1
    for name in ttf.BATCH_AXES:
        block = block * mesh.axis_size(name) + mesh.axis_index(name)
        blocks *= mesh.axis_size(name)
    mb = b // MICROBATCHES
    mbl = mb // blocks
    return [m * mb + block * mbl + i for m in range(MICROBATCHES) for i in range(mbl)]


def _record_router_margins(monkeypatch):
    margins = []
    real = ttf.moe_ffn_stats

    def spy(h, params, cfg, *group):
        logits = h.detach().reshape(-1, h.shape[-1]).float() @ params["router"].detach().float()
        top = torch.sort(logits, dim=-1, descending=True).values[:, : cfg.top_k + 1]
        margins.append(float((top[:, :-1] - top[:, 1:]).min()))
        return real(h, params, cfg, *group)

    monkeypatch.setattr(ttf, "moe_ffn_stats", spy)
    return margins


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_forward_pipelined_logits_and_grads_match_jax(mesh_name, monkeypatch):
    """Each rank's logits (its rows, chunk and vocabulary columns), the
    loss, the MoE aux, and every gradient gathered from the ranks, against
    JAX's ``forward_pipelined`` and ``jax.value_and_grad`` on the same mesh.
    The embedding's and the final norm's gradients are summed over the
    stages (the lookup's on the first, the head's on the last)."""
    shape, attn_impl, kw = MESHES[mesh_name]
    params, tree, tokens = _setup(kw.get("n_experts", 0))
    jcfg, tcfg = _configs(attn_impl, **kw)
    j_loss, j_logits, j_aux, j_grads = _jax_step(jcfg, params, tokens, shape)
    margins = _record_router_margins(monkeypatch) if tcfg.n_experts else None

    def body(r, mesh):
        model = convert.params_from_jax(tree, tcfg, device="cpu", mesh=mesh)
        tt = torch.from_numpy(tokens).long()
        rows = _rank_rows(mesh, tokens.shape[0])
        tl = tokens.shape[1] // mesh.axis_size("cp")
        start = mesh.axis_index("cp") * tl
        with torch.no_grad():
            logits, aux = ttf.forward_pipelined(
                model, tt[rows, start:start + tl], mesh, MICROBATCHES, return_aux=True)
        loss, grads = ttf.make_grad_step(tcfg, mesh, MICROBATCHES)(model, tt)
        vl = tcfg.vocab_size // mesh.axis_size("tp")
        cols = slice(mesh.axis_index("tp") * vl, (mesh.axis_index("tp") + 1) * vl)
        want = j_logits[rows, start:start + tl, cols]
        return logits.numpy(), want, float(aux), float(loss), grads

    ranks = run_mesh(shape, body)
    if margins is not None:
        # precondition: no routing sits near a tie (f32 through at most the
        # four blocks: the router inputs agree with JAX's to ~1e-6)
        assert min(margins) > 1e-4, min(margins)
    for logits, want, aux, loss, _ in ranks:
        np.testing.assert_allclose(logits, want, **LOGIT_TOL)
        np.testing.assert_allclose(aux, j_aux, rtol=2e-5, atol=1e-7)
        np.testing.assert_allclose(loss, j_loss, rtol=2e-5 if tcfg.n_experts else 1e-4,
                                   atol=0 if tcfg.n_experts else 5e-5)
    got = jax.tree_util.tree_leaves(convert.gather_to_jax([g for *_, g in ranks], tcfg, shape))
    want = jax.tree_util.tree_leaves(j_grads)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


@pytest.mark.parametrize("stages", [2, 4])
def test_embed_and_final_norm_grads_match_jax_grad(stages):
    """The replicated leaves under pp: the tied embedding gets its lookup
    gradient on stage 0 and its head gradient on the last stage, the final
    norm on the last stage alone; summed over the stages they are
    ``jax.grad``'s, counted once, on every stage."""
    params, tree, tokens = _setup()
    jcfg, tcfg = _configs("dense")
    _, _, _, j_grads = _jax_step(jcfg, params, tokens, {"pp": stages})

    def body(r, mesh):
        model = convert.params_from_jax(tree, tcfg, device="cpu", mesh=mesh)
        _, grads = ttf.make_grad_step(tcfg, mesh, MICROBATCHES)(
            model, torch.from_numpy(tokens).long())
        return grads["embed"], grads["final_norm"]

    for embed, norm in run_mesh({"pp": stages}, body):
        np.testing.assert_allclose(embed.numpy(), np.asarray(j_grads["embed"]), **TOL)
        np.testing.assert_allclose(norm.numpy(), np.asarray(j_grads["final_norm"]), **TOL)


def test_shard_params_keeps_a_stages_blocks_and_gather_params_restores_them():
    """Under ``{"pp": 2, "ep": 2}`` a rank holds its stage's two blocks, by
    their global names, with its half of each block's experts;
    ``gather_params`` (collective) gives every rank the whole model back,
    bit for bit."""
    _, tree, _ = _setup(4)
    _, tcfg = _configs("dense", n_experts=4, d_ff=48)

    def body(r, mesh):
        model = convert.params_from_jax(tree, tcfg, device="cpu", mesh=mesh)
        named = dict(model.named_parameters())
        return sorted(n for n in named if n.startswith("blocks.")), \
            tuple(model.blocks[ttf.stage_range(tcfg, mesh)[0]].w_gate.shape), \
            ttf.gather_params(named, tcfg, mesh)

    ranks = run_mesh({"pp": 2, "ep": 2}, body)
    for r, (names, w_gate, whole) in enumerate(ranks):
        stage = r // 2
        assert {int(n.split(".")[1]) for n in names} == {2 * stage, 2 * stage + 1}
        assert w_gate == (2, 32, 48)
        got = convert.params_to_jax(whole, tcfg)
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(tree)):
            np.testing.assert_array_equal(a, b)


def test_pipelined_flash_auto_and_the_whole_model_forward():
    """``attn_impl="flash"`` runs inside the pipe (the kernels' twins on
    the CPU; the JAX package refuses it there only for its compiler), and
    ``"auto"`` takes it on the card; the stage's model refuses the
    unpipelined forward."""
    _, tree, tokens = _setup()
    _, flash = _configs("flash", max_seq_len=128)
    _, dense = _configs("dense", max_seq_len=128)
    toks = np.random.default_rng(2).integers(0, 64, (4, 128))
    ref_model = convert.params_from_jax(tree, dense, device="cpu")
    with torch.no_grad():
        ref = ref_model(torch.from_numpy(toks).long())
    assert ttf._resolve_attn_impl(dataclasses.replace(flash, attn_impl="auto"), 128,
                                  torch.device("cuda")) == "flash"

    def body(r, mesh):
        model = convert.params_from_jax(tree, flash, device="cpu", mesh=mesh)
        with pytest.raises(ValueError, match="forward_pipelined"):
            model(torch.from_numpy(toks).long(), mesh=mesh)
        with torch.no_grad():
            return ttf.forward_pipelined(model, torch.from_numpy(toks).long(), mesh, 2)

    for logits in run_mesh({"pp": 2}, body):
        np.testing.assert_allclose(logits.numpy(), ref.numpy(), **LOGIT_TOL)
