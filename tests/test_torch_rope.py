"""The port's rope against the JAX package's.

On the CPU the port's wrapper runs its plain PyTorch version. It is held
against ``paddle_tpu.ops.pallas.rope.apply_rope`` run in interpret mode,
as the JAX tests run it on the CPU, on the same numpy inputs: both
pairings, ``[S, D]`` and per-batch ``[B, S, D]`` tables, fp32 and bf16,
values and the gradient (the JAX custom_vjp's -sin kernel against the
port's autograd rule). ``fused_rotary_position_embedding`` is held
against the JAX incubate function over q / k / v, given and computed
tables, ``position_ids``, ``time_major`` and both pairings.

Tolerances: fp32 1e-5 max abs (another op order inside the fp32 sums);
bf16 one bf16 rounding of the result (2**-8 of the largest reference
value) plus 1e-6, since both sides round an fp32 result that may differ
in its last bits.

On a card (``-m gpu``) the CUDA kernel is held against the plain
version: fp32 within 1e-5, bf16 within one bf16 rounding of the plain
version run in fp32 on the same inputs. JAX is imported inside a
fixture, so this file also collects on a machine without JAX.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.incubate.nn.functional import \
    fused_rotary_position_embedding as trope_fn
from paddle_tpu_torch.models import rope_angles
from paddle_tpu_torch.ops.cuda import rope as trope

B, S, H, D = 2, 16, 3, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests share the machine's cores with
    other test workers, and PyTorch's thread pool, spinning on small ops
    against them, slowed these CPU runs by two orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_mods():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    import paddle_tpu as paddle
    from paddle_tpu.incubate.nn import functional as jinc
    from paddle_tpu.ops.pallas import rope as jrope
    return jax, jnp, paddle, jinc, jrope


def _close(got, want, dtype, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    atol = (2.0 ** -8 * float(np.abs(want).max()) + 1e-6
            if dtype == "bfloat16" else 1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)


def _tables(rng, batched, neox):
    """fp32 tables tiled for the kernel's pairing at random positions."""
    pos = rng.integers(0, 64, (B, S) if batched else (S,))
    inv = 1.0 / 10000.0 ** (np.arange(D // 2) * 2.0 / D)
    ang = pos[..., None] * inv
    ang = (np.concatenate([ang, ang], -1) if neox
           else np.repeat(ang, 2, axis=-1))
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _torch(a, dtype):
    return torch.tensor(a).to(getattr(torch, dtype))


APPLY_CASES = {
    "half_shared_f32": (True, False, "float32"),
    "half_batched_f32": (True, True, "float32"),
    "interleaved_shared_f32": (False, False, "float32"),
    "interleaved_batched_f32": (False, True, "float32"),
    "half_shared_bf16": (True, False, "bfloat16"),
    "interleaved_batched_bf16": (False, True, "bfloat16"),
}


@pytest.mark.parametrize("name", sorted(APPLY_CASES))
def test_apply_rope_matches_jax(jax_mods, name):
    jax, jnp, _, _, jrope = jax_mods
    neox, batched, dtype = APPLY_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    x = rng.normal(size=(B, S, H, D)).astype(np.float32)
    g = rng.normal(size=(B, S, H, D)).astype(np.float32)
    cos, sin = _tables(rng, batched, neox)
    jdt = getattr(jnp, dtype)
    jx, jg = jnp.asarray(x, jdt), jnp.asarray(g, jdt)
    jout, vjp = jax.vjp(lambda v: jrope.apply_rope(
        v, jnp.asarray(cos), jnp.asarray(sin), use_neox=neox,
        interpret=True), jx)
    (jdx,) = vjp(jg)

    tx = _torch(x, dtype).requires_grad_()
    out = trope.apply_rope(tx, torch.tensor(cos), torch.tensor(sin),
                           use_neox=neox)
    assert out.dtype == tx.dtype and out.shape == (B, S, H, D)
    out.backward(_torch(g, dtype))
    _close(out.detach().float(), np.asarray(jout, np.float32), dtype, "out")
    _close(tx.grad.float(), np.asarray(jdx, np.float32), dtype, "dx")
    # the plain version is the function itself, and the rotation's
    # transpose is the rotation by -theta
    plain = trope.rope_plain(tx.detach(), torch.tensor(cos),
                             torch.tensor(sin), neox)
    assert torch.equal(plain, out.detach())


# name: (q, k, v present), tables given, position_ids, time_major,
# paddle's use_neox_rotary_style, dtype, check grads
INCUBATE_CASES = {
    "q_computed_interleaved": ("q", False, False, False, True, "float32",
                               False),
    "qk_tables_half_llama": ("qk", True, False, False, False, "float32",
                             True),
    "qkv_tables_position_ids_bf16": ("qkv", True, True, False, False,
                                     "bfloat16", False),
    "qk_time_major_computed": ("qk", False, False, True, False, "float32",
                               False),
    "qv_computed_position_ids": ("qv", False, True, False, True, "float32",
                                 False),
    "q_4d_tables_time_major": ("q", True, False, True, True, "float32",
                               False),
}


@pytest.mark.parametrize("name", sorted(INCUBATE_CASES))
def test_fused_rotary_position_embedding_matches_jax(jax_mods, name):
    _, _, paddle, jinc, _ = jax_mods
    which, tables, with_pid, time_major, style, dtype, grads = \
        INCUBATE_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    lead = (S, B) if time_major else (B, S)
    arrs = {n: rng.normal(size=lead + (H, D)).astype(np.float32)
            for n in which}
    cots = {n: rng.normal(size=lead + (H, D)).astype(np.float32)
            for n in which}
    kw = dict(use_neox_rotary_style=style, time_major=time_major)
    np_tabs = None
    if tables:
        n_pos = 40 if with_pid else S
        ang = np.arange(n_pos)[:, None] * (
            1.0 / 50000.0 ** (np.arange(D // 2) * 2.0 / D))
        ang = (np.repeat(ang, 2, -1) if style
               else np.concatenate([ang, ang], -1))
        np_tabs = (np.sin(ang).astype(np.float32),
                   np.cos(ang).astype(np.float32))
        if name.startswith("q_4d"):
            np_tabs = tuple(t[None, :, None, :] for t in np_tabs)
    pid = rng.integers(0, 40 if tables else 100, (B, S)) if with_pid \
        else None

    def run_jax():
        ts = {n: paddle.to_tensor(a).astype(dtype) for n, a in arrs.items()}
        for t in ts.values():
            t.stop_gradient = not grads
        jkw = dict(kw)
        if np_tabs is not None:
            jkw.update(sin=paddle.to_tensor(np_tabs[0]),
                       cos=paddle.to_tensor(np_tabs[1]))
        if pid is not None:
            jkw["position_ids"] = paddle.to_tensor(pid)
        outs = jinc.fused_rotary_position_embedding(
            ts["q"], ts.get("k"), ts.get("v"), **jkw)
        if grads:
            loss = None
            for n, o in zip(which, outs):
                term = (o.astype("float32")
                        * paddle.to_tensor(cots[n])).sum()
                loss = term if loss is None else loss + term
            loss.backward()
        return ([None if o is None else np.asarray(o.astype("float32")
                                                   .numpy()) for o in outs],
                {n: np.asarray(t.grad.astype("float32").numpy())
                 for n, t in ts.items()} if grads else None)

    jouts, jgrads = run_jax()
    ts = {n: _torch(a, dtype).requires_grad_(grads)
          for n, a in arrs.items()}
    tkw = dict(kw)
    if np_tabs is not None:
        tkw.update(sin=torch.tensor(np_tabs[0]), cos=torch.tensor(np_tabs[1]))
    if pid is not None:
        tkw["position_ids"] = torch.tensor(pid)
    outs = trope_fn(ts["q"], ts.get("k"), ts.get("v"), **tkw)
    assert len(outs) == 3
    assert [o is None for o in outs] == [o is None for o in jouts]
    for i, (o, jo) in enumerate(zip(outs, jouts)):
        if o is not None:
            assert tuple(o.shape) == tuple(jo.shape)
            _close(o.detach().float(), jo, dtype, f"out {i}")
    if grads:
        loss = sum((o.float() * torch.tensor(cots[n])).sum()
                   for n, o in zip(which, outs))
        loss.backward()
        for n, t in ts.items():
            _close(t.grad.float(), jgrads[n], dtype, f"d{n}")


def test_rope_angles_match_jax(jax_mods):
    from paddle_tpu.models.llama import rope_angles as jangles
    for theta in (10000.0, 500000.0):
        jc, js = jangles(np.arange(2048), 128, theta)
        tc, ts = rope_angles(np.arange(2048), 128, theta)
        assert tc.dtype == torch.float32
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_rope_refusals():
    x = torch.zeros(1, 4, 2, 8)
    cos = torch.ones(4, 8)
    with pytest.raises(ValueError, match="interpret"):
        trope.apply_rope(x, cos, cos, interpret=True)
    with pytest.raises(ValueError, match="tables must be"):
        trope.rope(x, torch.ones(5, 8), torch.ones(5, 8))
    with pytest.raises(ValueError, match="even"):
        trope.rope(torch.zeros(1, 4, 2, 7), torch.ones(4, 7),
                   torch.ones(4, 7))
    before = trope.rope.launches
    m = torch.zeros(1, 4, 2, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        trope.rope(m, cos.to("meta"), cos.to("meta"))
    trope.rope(x, cos, cos)            # CPU: the plain version, not counted
    assert trope.rope.launches == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("neox", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batched", [False, True])
def test_kernel_matches_plain_on_card(cuda, neox, dtype, batched):
    gen = torch.Generator(device=cuda).manual_seed(0)
    b, s, h, d = 2, 64, 4, 128
    # a strided view, as the time-major path hands the kernel
    x = torch.randn(s, b, h, d, generator=gen, device=cuda).to(dtype) \
        .transpose(0, 1)
    cos, sin = (t.to(cuda) for t in rope_angles(np.arange(s), d, 1e4))
    if not neox:
        # interleaved tiling (each frequency twice in a row): a rotation
        # of each (2i, 2i + 1) pair, which -theta undoes
        cos, sin = (t[:, :d // 2].repeat_interleave(2, dim=-1)
                    for t in (cos, sin))
    if batched:
        idx = torch.randint(0, s, (b, s), generator=gen, device=cuda)
        cos, sin = cos[idx], sin[idx]
    before = trope.rope.launches
    out = trope.rope(x, cos, sin, neox)
    back = trope.rope(out, cos, sin, neox, neg_sin=True)
    torch.cuda.synchronize()
    assert trope.rope.launches == before + 2
    ref = trope.rope_plain(x.float(), cos, sin, neox)
    tol = (2.0 ** -8 * float(ref.abs().max()) + 1e-6
           if dtype == torch.bfloat16 else 1e-5)
    assert float((out.float() - ref).abs().max()) <= tol
    # rotating back by -theta recovers x
    assert float((back.float() - x.float()).abs().max()) <= 4 * tol
