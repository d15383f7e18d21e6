"""The port's fused residual + RMSNorm against the JAX package's.

On the CPU the port's wrappers run their plain PyTorch versions. They are
held against ``paddle_tpu.ops.pallas.fused_residual_norm``'s
``fused_residual_rms_norm_fwd`` / ``_bwd`` run in interpret mode, as the
JAX tests run them on the CPU, and the port's differentiable entry
against ``jax.vjp`` of the JAX one, on the same numpy inputs. 300 rows
are not a multiple of the TPU kernel's 256-row block (the JAX side pads
a tail block).

Tolerances: fp32 1e-5 max abs (another summation order in the row
reductions) and dw, a sum over rows, 1e-5 of its largest value; bf16 one
bf16 ulp of the largest reference value (2**-7 of it) plus 1e-6: both
sides round an fp32 result to bf16, and XLA may keep the bf16 residual
sum in excess precision where the port rounds it, so the two roundings
can land one ulp apart.

On a card (``-m gpu``) the CUDA kernels are held against the plain
versions: fp32 within 1e-5 (dw within 1e-5 of its column's sum of
magnitudes), bf16 within one bf16 rounding of the plain version run in
fp32 on the same inputs (two for ``normed``, whose residual sum the
kernel rounds to bf16 first). JAX is imported inside a fixture, so this file
also collects on a machine without JAX.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops.cuda import fused_residual_norm as tfr

EPS = 1e-6


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

    from paddle_tpu.ops.pallas import fused_residual_norm as jfr
    return jax, jnp, jfr


def _close(got, want, dtype, what, rel=False):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    big = float(np.abs(want).max())
    if dtype == "bfloat16":
        atol = 2.0 ** -7 * big + 1e-6
    else:
        atol = 1e-5 * big if rel else 1e-5
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)


def _inputs(seed, n, h):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in
            ((n, h), (n, h), (h,), (n, h), (n, h))]


def _t(a, dtype):
    return torch.tensor(a).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h", [(300, 64), (8, 128)])
def test_kernels_plain_versions_match_jax(jax_mods, n, h, dtype):
    _, jnp, jfr = jax_mods
    x, y, w, dres, dn = _inputs(n + h, n, h)
    w = 1.0 + 0.1 * w
    jdt = getattr(jnp, dtype)
    jx, jy, jw, jdr, jdn = (jnp.asarray(a, jdt) for a in (x, y, w, dres, dn))
    jres, jnormed, jrstd = jfr.fused_residual_rms_norm_fwd(
        jx, jy, jw, eps=EPS, interpret=True)
    jd, jdw = jfr.fused_residual_rms_norm_bwd(
        jres, jw, jrstd, jdr, jdn, eps=EPS, interpret=True)

    tx, ty, tw, tdr, tdn = (_t(a, dtype) for a in (x, y, w, dres, dn))
    res, normed, rstd = tfr.fused_residual_rms_norm_fwd(tx, ty, tw, EPS)
    assert res.dtype == normed.dtype == tx.dtype
    assert rstd.dtype == torch.float32 and tuple(rstd.shape) == (n, 1)
    _close(res.float(), jres.astype(jnp.float32), dtype, "res")
    _close(normed.float(), jnormed.astype(jnp.float32), dtype, "normed")
    # rstd is fp32 but, with bf16 rows, a function of the bf16 residual
    # sum that XLA may keep in excess precision: the bf16 tolerance
    _close(rstd, jrstd, dtype, "rstd")
    # the backward from the JAX forward's saved values
    d, dw = tfr.fused_residual_rms_norm_bwd(
        _t(np.asarray(jres.astype(jnp.float32)), dtype), tw,
        torch.tensor(np.asarray(jrstd)), tdr, tdn)
    assert d.dtype == tx.dtype and dw.dtype == tw.dtype
    _close(d.float(), jd.astype(jnp.float32), dtype, "d")
    _close(dw.float(), jdw.astype(jnp.float32), dtype, "dw", rel=True)


@pytest.mark.parametrize("use_res", [True, False])
def test_differentiable_entry_matches_jax_grads(jax_mods, use_res):
    """Grads of x, y and w through ``fused_residual_rms_norm`` (the
    custom op) against ``jax.vjp`` of the JAX entry; without ``use_res``
    the residual output is discarded (LLaMA's final norm), so its
    cotangent is zero on the JAX side and missing on the port's."""
    jax, jnp, jfr = jax_mods
    x, y, w, dres, dn = _inputs(7, 300, 64)
    x, y, dres, dn = (a.reshape(3, 100, 64) for a in (x, y, dres, dn))
    w = 1.0 + 0.1 * w
    if not use_res:
        dres = np.zeros_like(dres)
    (jr, jo), vjp = jax.vjp(lambda a, b, c: jfr.fused_residual_rms_norm(
        a, b, c, eps=EPS, interpret=True), jnp.asarray(x), jnp.asarray(y),
        jnp.asarray(w))
    jdx, jdy, jdw = vjp((jnp.asarray(dres), jnp.asarray(dn)))

    tx, ty, tw = (torch.tensor(a).requires_grad_() for a in (x, y, w))
    r, o = tfr.fused_residual_rms_norm(tx, ty, tw, eps=EPS)
    assert r.shape == o.shape == (3, 100, 64)
    _close(r.detach(), jr, "float32", "res")
    _close(o.detach(), jo, "float32", "normed")
    loss = (o * torch.tensor(dn)).sum()
    if use_res:
        loss = loss + (r * torch.tensor(dres)).sum()
    loss.backward()
    _close(tx.grad, jdx, "float32", "dx")
    _close(ty.grad, jdy, "float32", "dy")
    _close(tw.grad, jdw, "float32", "dw", rel=True)
    assert torch.equal(tx.grad, ty.grad)      # the shared cotangent


def test_backward_without_dres_is_zero_dres():
    x, y, w, dres, dn = (torch.tensor(a) for a in _inputs(3, 20, 32))
    res, _, rstd = tfr.fused_residual_rms_norm_fwd(x, y, w, EPS)
    d0, dw0 = tfr.fused_residual_rms_norm_bwd(res, w, rstd, None, dn)
    dz, dwz = tfr.fused_residual_rms_norm_bwd(res, w, rstd,
                                              torch.zeros_like(dn), dn)
    assert torch.equal(d0, dz) and torch.equal(dw0, dwz)


def test_fused_residual_norm_functional():
    x, y, w, _, _ = (torch.tensor(a) for a in _inputs(5, 6, 16))
    r, o = TF.fused_residual_norm(x, y, w, norm="rms")
    rr, ro, _ = tfr.fused_residual_rms_norm_fwd_plain(x, y, w, 1e-6)
    assert torch.equal(r, rr) and torch.equal(o, ro)
    r, o = TF.fused_residual_norm(x, y, w, norm="rms", epsilon=1e-3)
    assert torch.equal(o, tfr.fused_residual_rms_norm_fwd_plain(
        x, y, w, 1e-3)[1])
    # neither AMP list: under O2 the inputs go in as bf16
    with tamp.auto_cast(level="O2", dtype="bfloat16"):
        r, o = TF.fused_residual_norm(x, y, w, norm="rms")
    assert r.dtype == o.dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="#9-#10"):
        TF.fused_residual_norm(x, y, w, torch.zeros(16), norm="layer")
    with pytest.raises(ValueError, match="requires bias"):
        TF.fused_residual_norm(x, y, w, norm="layer")
    with pytest.raises(ValueError, match="'layer' or 'rms'"):
        TF.fused_residual_norm(x, y, w, norm="group")


def test_rms_norm_runs_in_fp32_under_amp():
    x = torch.randn(4, 16).to(torch.bfloat16)
    w = torch.ones(16, dtype=torch.bfloat16)
    with tamp.auto_cast(level="O2", dtype="bfloat16"):
        out = TF.rms_norm(x, w)
    assert out.dtype == torch.float32
    x32 = x.float()
    want = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + 1e-6)
    assert torch.equal(out, want)


def test_wrappers_refuse_devices_without_a_kernel():
    wrappers = (tfr.fused_residual_rms_norm_fwd,
                tfr.fused_residual_rms_norm_bwd)
    before = [f.launches for f in wrappers]
    m = torch.zeros(4, 16, device="meta")
    w = torch.zeros(16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tfr.fused_residual_rms_norm_fwd(m, m, w)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tfr.fused_residual_rms_norm_bwd(m, w, torch.zeros(4, 1,
                                                          device="meta"),
                                        None, m)
    with pytest.raises(ValueError, match="interpret"):
        tfr.fused_residual_rms_norm(m, m, w, interpret=True)
    assert [f.launches for f in wrappers] == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h", [(4096, 4096), (4093, 4096), (37, 200)])
def test_kernels_match_plain_on_card(cuda, n, h, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)

    def rn(*s):
        return torch.randn(*s, generator=gen, device=cuda)
    x, y, dres, dn = (rn(n, h).to(dtype) for _ in range(4))
    w = (1.0 + 0.1 * rn(h)).to(dtype)
    fb = [tfr.fused_residual_rms_norm_fwd.launches,
          tfr.fused_residual_rms_norm_bwd.launches]
    res, normed, rstd = tfr.fused_residual_rms_norm_fwd(x, y, w, EPS)
    d, dw = tfr.fused_residual_rms_norm_bwd(res, w, rstd, dres, dn)
    torch.cuda.synchronize()
    assert [tfr.fused_residual_rms_norm_fwd.launches,
            tfr.fused_residual_rms_norm_bwd.launches] == [fb[0] + 1,
                                                          fb[1] + 1]
    f32 = [t.float() for t in (x, y, w, dres, dn)]
    rres, rnormed, rrstd = tfr.fused_residual_rms_norm_fwd_plain(
        *f32[:3], EPS)
    rd, rdw = tfr.fused_residual_rms_norm_bwd_plain(
        res.float(), f32[2], rstd, f32[3], f32[4])
    bf = dtype == torch.bfloat16

    def lim(ref, roundings=1):
        return (roundings * 2.0 ** -8 * float(ref.abs().max()) + 1e-6
                if bf else 1e-5)
    # bf16 normed rounds twice: the residual sum before the stats (the
    # plain version in fp32 does not) and the output
    for got, ref, k in ((res, rres, 1), (normed, rnormed, 2),
                        (rstd, rrstd, 1), (d, rd, 1)):
        assert float((got.float() - ref).abs().max()) <= lim(ref, k)
    colsum = float((f32[4] * res.float() * rstd).abs().sum(0).max())
    dw_lim = lim(rdw) if bf else 1e-5 * colsum
    assert float((dw.float() - rdw).abs().max()) <= dw_lim
