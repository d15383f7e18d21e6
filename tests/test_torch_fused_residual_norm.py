"""The port's fused residual + RMSNorm and residual + LayerNorm against
the JAX package's.

On the CPU the port's wrappers run their plain PyTorch versions. They are
held against ``paddle_tpu.ops.pallas.fused_residual_norm``'s
``fused_residual_rms_norm_fwd`` / ``_bwd`` and
``fused_residual_layer_norm_fwd`` / ``_bwd`` run in interpret mode, as
the JAX tests run them on the CPU, and the port's differentiable entries
against ``jax.vjp`` of the JAX ones, on the same numpy inputs. 300 rows
are not a multiple of the TPU kernels' 256-row block (the JAX side pads
a tail block); 1 row is the smallest. The LayerNorm pair's JAX outputs
are built once per module.

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


LN_EPS = 1e-5
LN_SHAPES = [(1, 96), (300, 96)]


def _ln_inputs(n, h):
    x, y, w, dres, dn = _inputs(n + 2 * h, n, h)
    b = np.random.default_rng(n).normal(size=h).astype(np.float32)
    return x, y, 1.0 + 0.1 * w, b, dres, dn


@pytest.fixture(scope="module")
def jax_layer_pair(jax_mods):
    """The JAX LayerNorm pair's outputs, interpret mode, for every (rows,
    h, dtype), built once: ``(res, normed, mean, rstd, d, dw, db)`` as
    fp32 numpy, the backward from the forward's own saved values."""
    _, jnp, jfr = jax_mods
    out = {}
    for n, h in LN_SHAPES:
        for dtype in ("float32", "bfloat16"):
            jdt = getattr(jnp, dtype)
            x, y, w, b, dres, dn = (jnp.asarray(a, jdt)
                                    for a in _ln_inputs(n, h))
            res, normed, mean, rstd = jfr.fused_residual_layer_norm_fwd(
                x, y, w, b, eps=LN_EPS, interpret=True)
            d, dw, db = jfr.fused_residual_layer_norm_bwd(
                res, w, mean, rstd, dres, dn, eps=LN_EPS, interpret=True)
            out[(n, h, dtype)] = [np.asarray(a.astype(jnp.float32)) for a in
                                  (res, normed, mean, rstd, d, dw, db)]
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h", LN_SHAPES)
def test_layer_kernels_plain_versions_match_jax(jax_layer_pair, n, h,
                                                dtype):
    jres, jnormed, jmean, jrstd, jd, jdw, jdb = jax_layer_pair[(n, h, dtype)]
    tx, ty, tw, tb, tdr, tdn = (_t(a, dtype) for a in _ln_inputs(n, h))
    res, normed, mean, rstd = tfr.fused_residual_layer_norm_fwd(
        tx, ty, tw, tb, LN_EPS)
    assert res.dtype == normed.dtype == tx.dtype
    assert mean.dtype == rstd.dtype == torch.float32
    assert tuple(mean.shape) == tuple(rstd.shape) == (n, 1)
    _close(res.float(), jres, dtype, "res")
    _close(normed.float(), jnormed, dtype, "normed")
    # stats are fp32 but, with bf16 rows, functions of the bf16 residual
    # sum: the bf16 tolerance there
    _close(mean, jmean, dtype, "mean")
    _close(rstd, jrstd, dtype, "rstd", rel=True)
    d, dw, db = tfr.fused_residual_layer_norm_bwd(
        _t(jres, dtype), tw, torch.tensor(jmean), torch.tensor(jrstd), tdr,
        tdn)
    assert d.dtype == tx.dtype and dw.dtype == db.dtype == tw.dtype
    _close(d.float(), jd, dtype, "d")
    _close(dw.float(), jdw, dtype, "dw", rel=True)
    _close(db.float(), jdb, dtype, "db", rel=True)
    d0, dw0, db0 = tfr.fused_residual_layer_norm_bwd(
        _t(jres, dtype), tw, torch.tensor(jmean), torch.tensor(jrstd), None,
        tdn)
    dz = tfr.fused_residual_layer_norm_bwd(
        _t(jres, dtype), tw, torch.tensor(jmean), torch.tensor(jrstd),
        torch.zeros_like(tdn), tdn)
    assert all(torch.equal(p, q) for p, q in zip((d0, dw0, db0), dz))


@pytest.mark.parametrize("use_res", [True, False])
def test_layer_entry_matches_jax_grads(jax_mods, use_res):
    """Grads of x, y, w and b through ``fused_residual_layer_norm`` (the
    custom op) against ``jax.vjp`` of the JAX entry; without ``use_res``
    the residual output is discarded (GPT's final norm)."""
    jax, jnp, jfr = jax_mods
    x, y, w, b, dres, dn = (a.reshape((3, 100, 64)) if a.ndim == 2 else a
                            for a in _ln_inputs(300, 64))
    if not use_res:
        dres = np.zeros_like(dres)
    (jr, jo), vjp = jax.vjp(
        lambda *a: jfr.fused_residual_layer_norm(*a, eps=LN_EPS,
                                                 interpret=True),
        *(jnp.asarray(a) for a in (x, y, w, b)))
    jgrads = vjp((jnp.asarray(dres), jnp.asarray(dn)))

    targs = [torch.tensor(a).requires_grad_() for a in (x, y, w, b)]
    r, o = tfr.fused_residual_layer_norm(*targs, eps=LN_EPS)
    assert r.shape == o.shape == (3, 100, 64)
    _close(r.detach(), jr, "float32", "res")
    _close(o.detach(), jo, "float32", "normed")
    loss = (o * torch.tensor(dn)).sum()
    if use_res:
        loss = loss + (r * torch.tensor(dres)).sum()
    loss.backward()
    for name, t, jg in zip(("dx", "dy", "dw", "db"), targs, jgrads):
        _close(t.grad, jg, "float32", name, rel=name in ("dw", "db"))
    assert torch.equal(targs[0].grad, targs[1].grad)   # shared cotangent


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
    # norm="layer": the fused residual + LayerNorm pair
    b = torch.linspace(-1.0, 1.0, 16)
    r, o = TF.fused_residual_norm(x, y, w, b, norm="layer")
    rr, ro, _, _ = tfr.fused_residual_layer_norm_fwd_plain(x, y, w, b, 1e-5)
    assert torch.equal(r, rr) and torch.equal(o, ro)
    torch.testing.assert_close(
        o, torch.nn.functional.layer_norm(x + y, (16,), w, b), rtol=0,
        atol=1e-5)
    with tamp.auto_cast(level="O2", dtype="bfloat16"):
        r, o = TF.fused_residual_norm(x, y, w, b, norm="layer")
    assert r.dtype == o.dtype == torch.bfloat16
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
                tfr.fused_residual_rms_norm_bwd,
                tfr.fused_residual_layer_norm_fwd,
                tfr.fused_residual_layer_norm_bwd)
    before = [f.launches for f in wrappers]
    m = torch.zeros(4, 16, device="meta")
    w = torch.zeros(16, device="meta")
    s = torch.zeros(4, 1, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tfr.fused_residual_rms_norm_fwd(m, m, w)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tfr.fused_residual_rms_norm_bwd(m, w, s, None, m)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tfr.fused_residual_layer_norm_fwd(m, m, w, w)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tfr.fused_residual_layer_norm_bwd(m, w, s, s, None, m)
    with pytest.raises(ValueError, match="interpret"):
        tfr.fused_residual_rms_norm(m, m, w, interpret=True)
    with pytest.raises(ValueError, match="interpret"):
        tfr.fused_residual_layer_norm(m, m, w, w, interpret=True)
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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h", [(8192, 768), (8191, 768), (37, 203)])
def test_layer_kernels_match_plain_on_card(cuda, n, h, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)

    def rn(*s):
        return torch.randn(*s, generator=gen, device=cuda)
    x, y, dres, dn = (rn(n, h).to(dtype) for _ in range(4))
    w, b = (1.0 + 0.1 * rn(h)).to(dtype), rn(h).to(dtype)
    fb = [tfr.fused_residual_layer_norm_fwd.launches,
          tfr.fused_residual_layer_norm_bwd.launches]
    res, normed, mean, rstd = tfr.fused_residual_layer_norm_fwd(x, y, w, b,
                                                                1e-5)
    d, dw, db = tfr.fused_residual_layer_norm_bwd(res, w, mean, rstd, dres,
                                                  dn)
    torch.cuda.synchronize()
    assert [tfr.fused_residual_layer_norm_fwd.launches,
            tfr.fused_residual_layer_norm_bwd.launches] == [fb[0] + 1,
                                                            fb[1] + 1]
    f32 = [t.float() for t in (x, y, w, b, dres, dn)]
    rres, rnormed, rmean, _ = tfr.fused_residual_layer_norm_fwd_plain(
        *f32[:4], 1e-5)
    rd, rdw, rdb = tfr.fused_residual_layer_norm_bwd_plain(
        res.float(), f32[2], mean, rstd, f32[4], f32[5])
    bf = dtype == torch.bfloat16

    def lim(ref, roundings=1):
        return (roundings * 2.0 ** -8 * float(ref.abs().max()) + 1e-6
                if bf else 1e-5)
    for got, ref, k in ((res, rres, 1), (normed, rnormed, 2),
                        (mean, rmean, 1), (d, rd, 1)):
        assert float((got.float() - ref).abs().max()) <= lim(ref, k)
    xhat = (res.float() - mean) * rstd
    for got, ref, terms in ((dw, rdw, f32[5] * xhat), (db, rdb, f32[5])):
        tol = lim(ref) if bf else 1e-5 * float(terms.abs().sum(0).max())
        assert float((got.float() - ref).abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_kernels_read_weights_in_their_own_dtype_on_card(cuda, dtype,
                                                               wdtype):
    """The fused LayerNorm pair with weights of either dtype beside rows
    of either: bitwise the kernels on the weights widened to fp32, and
    dw, db in the weights' dtype."""
    gen = torch.Generator(device=cuda).manual_seed(3)

    def rn(*s):
        return torch.randn(*s, generator=gen, device=cuda)
    x, y, dres, dn = (rn(8191, 768).to(dtype) for _ in range(4))
    w, b = (1.0 + 0.1 * rn(768)).to(wdtype), rn(768).to(wdtype)
    got = tfr.fused_residual_layer_norm_fwd(x, y, w, b, 1e-5)
    ref = tfr.fused_residual_layer_norm_fwd(x, y, w.float(), b.float(),
                                            1e-5)
    assert all(torch.equal(p, q) for p, q in zip(got, ref))
    res, _, mean, rstd = got
    d, dw, db = tfr.fused_residual_layer_norm_bwd(res, w, mean, rstd, dres,
                                                  dn)
    rd, rdw, rdb = tfr.fused_residual_layer_norm_bwd(res, w.float(), mean,
                                                     rstd, dres, dn)
    assert torch.equal(d, rd)
    assert dw.dtype == db.dtype == wdtype
    assert torch.equal(dw, rdw.to(wdtype)) and torch.equal(db, rdb.to(wdtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [64, 768, 1024, 4096, "largest"])
@pytest.mark.parametrize("n", [1, 7, 8191, 8192])
def test_layer_bwd_kernel_matches_plain_on_card(cuda, n, h, dtype):
    """The one-launch Layer backward (row 10) at every group size its
    plan picks, with dres and without (``None``: zero), against the
    plain version on the kernel's own res and stats (tolerances as
    above); one launch a call; a second run bitwise equal."""
    if h == "largest":
        h = 8 * 256 * (16 // dtype.itemsize)
    gen = torch.Generator(device=cuda).manual_seed(6)

    def rn(*s):
        return torch.randn(*s, generator=gen, device=cuda)
    x, y, dres, dn = (rn(n, h).to(dtype) for _ in range(4))
    w, b = (1.0 + 0.1 * rn(h)).to(dtype), rn(h).to(dtype)
    res, _, mean, rstd = tfr.fused_residual_layer_norm_fwd(x, y, w, b, 1e-5)
    before = tfr.fused_residual_layer_norm_bwd.launches
    got = tfr.fused_residual_layer_norm_bwd(res, w, mean, rstd, dres, dn)
    got0 = tfr.fused_residual_layer_norm_bwd(res, w, mean, rstd, None, dn)
    torch.cuda.synchronize()
    assert tfr.fused_residual_layer_norm_bwd.launches == before + 2
    f32 = [t.float() for t in (res, w, dres, dn)]
    bf = dtype == torch.bfloat16

    def lim(ref):
        return 2.0 ** -8 * float(ref.abs().max()) + 1e-6 if bf else 1e-5
    xhat = (f32[0] - mean) * rstd
    for (d, dw, db), r in ((got, f32[2]), (got0, None)):
        rd, rdw, rdb = tfr.fused_residual_layer_norm_bwd_plain(
            f32[0], f32[1], mean, rstd, r, f32[3])
        assert float((d.float() - rd).abs().max()) <= lim(rd)
        for g_, ref, terms in ((dw, rdw, f32[3] * xhat),
                               (db, rdb, f32[3])):
            tol = lim(ref) if bf else 1e-5 * float(
                terms.abs().sum(0).max())
            assert float((g_.float() - ref).abs().max()) <= tol
    again = tfr.fused_residual_layer_norm_bwd(res, w, mean, rstd, dres, dn)
    assert all(torch.equal(p, q) for p, q in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
def test_layer_bwd_one_element_loads_on_card(cuda, wdtype):
    """bf16 rows one element off 16-byte alignment (the kernel's
    one-element path, 4 warps a row) beside fp32 and bf16 weights: the
    plain version's results within one bf16 rounding, dw and db in the
    weights' dtype."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    n, h = 8191, 768

    def rows():
        flat = torch.randn(n * h + 1, generator=gen, device=cuda)
        return flat.to(torch.bfloat16)[1:].view(n, h)
    res, dres, dn = rows(), rows(), rows()
    assert res.data_ptr() % 16
    w = (1.0 + 0.1 * torch.randn(h, generator=gen, device=cuda)).to(wdtype)
    mean = res.float().mean(1, keepdim=True)
    rstd = torch.rsqrt((res.float() - mean).square().mean(1, keepdim=True)
                       + 1e-5)
    d, dw, db = tfr.fused_residual_layer_norm_bwd(res, w, mean, rstd, dres,
                                                  dn)
    assert dw.dtype == db.dtype == wdtype
    rd, rdw, rdb = tfr.fused_residual_layer_norm_bwd_plain(
        res.float(), w.float(), mean, rstd, dres.float(), dn.float())
    for got, ref in ((d, rd), (dw, rdw), (db, rdb)):
        assert float((got.float() - ref).abs().max()) <= (
            2.0 ** -8 * float(ref.abs().max()) + 1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [64, 768, 1024, 4096, "largest"])
@pytest.mark.parametrize("n", [1, 7, 8191, 8192])
def test_rms_bwd_kernel_matches_plain_on_card(cuda, n, h, dtype):
    """The one-launch RMS backward (row 12) at every group size its plan
    picks, with dres and without (``None``: zero), against the plain
    version on the kernel's own res and rstd (tolerances as above); one
    launch a call; a second run bitwise equal."""
    if h == "largest":
        h = 8 * 256 * (16 // dtype.itemsize)
    gen = torch.Generator(device=cuda).manual_seed(8)

    def rn(*s):
        return torch.randn(*s, generator=gen, device=cuda)
    x, y, dres, dn = (rn(n, h).to(dtype) for _ in range(4))
    w = (1.0 + 0.1 * rn(h)).to(dtype)
    res, _, rstd = tfr.fused_residual_rms_norm_fwd(x, y, w, EPS)
    before = tfr.fused_residual_rms_norm_bwd.launches
    got = tfr.fused_residual_rms_norm_bwd(res, w, rstd, dres, dn)
    got0 = tfr.fused_residual_rms_norm_bwd(res, w, rstd, None, dn)
    torch.cuda.synchronize()
    assert tfr.fused_residual_rms_norm_bwd.launches == before + 2
    f32 = [t.float() for t in (res, w, dres, dn)]
    bf = dtype == torch.bfloat16

    def lim(ref):
        return 2.0 ** -8 * float(ref.abs().max()) + 1e-6 if bf else 1e-5
    colsum = float((f32[3] * f32[0] * rstd).abs().sum(0).max())
    for (d, dw), r in ((got, f32[2]), (got0, None)):
        assert d.dtype == dtype and dw.dtype == w.dtype
        rd, rdw = tfr.fused_residual_rms_norm_bwd_plain(
            f32[0], f32[1], rstd, r, f32[3])
        assert float((d.float() - rd).abs().max()) <= lim(rd)
        tol = lim(rdw) if bf else 1e-5 * colsum
        assert float((dw.float() - rdw).abs().max()) <= tol
    again = tfr.fused_residual_rms_norm_bwd(res, w, rstd, dres, dn)
    assert all(torch.equal(p, q) for p, q in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
def test_rms_kernels_read_weights_in_their_own_dtype_on_card(cuda, wdtype,
                                                             aligned):
    """The fused RMS pair with fp32 and bf16 weights beside bf16 rows,
    with 16-byte loads and without (rows one element off alignment: the
    one-element path): the forward and d bitwise the kernels' on the
    weights widened to fp32, dw that sum rounded once to the weights'
    dtype, and the backward within one bf16 rounding of the plain
    version."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    for n, h in ((4093, 4096), (4093, 2048), (37, 200)):
        if not aligned and h > 2048:
            continue          # one-element loads take rows of 2048 at most

        def rows():
            flat = torch.randn(n * h + 1, generator=gen, device=cuda)
            flat = flat.to(torch.bfloat16)
            return (flat[:-1] if aligned else flat[1:]).view(n, h)
        x, y, dres, dn = rows(), rows(), rows(), rows()
        w = (1.0 + 0.1 * torch.randn(h, generator=gen, device=cuda)).to(
            wdtype)
        got = tfr.fused_residual_rms_norm_fwd(x, y, w, EPS)
        ref = tfr.fused_residual_rms_norm_fwd(x, y, w.float(), EPS)
        assert all(torch.equal(p, q) for p, q in zip(got, ref))
        res, _, rstd = got
        for dr in (dres, None):
            d, dw = tfr.fused_residual_rms_norm_bwd(res, w, rstd, dr, dn)
            rd, rdw = tfr.fused_residual_rms_norm_bwd(res, w.float(), rstd,
                                                      dr, dn)
            assert dw.dtype == wdtype
            assert torch.equal(d, rd) and torch.equal(dw, rdw.to(wdtype))
            pd, pdw = tfr.fused_residual_rms_norm_bwd_plain(
                res.float(), w.float(), rstd,
                None if dr is None else dr.float(), dn.float())
            for g_, r_ in ((d, pd), (dw, pdw)):
                assert float((g_.float() - r_).abs().max()) <= (
                    2.0 ** -8 * float(r_.abs().max()) + 1e-6)
