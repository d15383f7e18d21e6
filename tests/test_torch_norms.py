"""The port's norm kernels and the functionals that reach them, against
the JAX package's.

On the CPU the wrappers of ``paddle_tpu_torch.ops.cuda.norms`` run their
plain PyTorch versions. They are held against
``paddle_tpu.ops.pallas.norms``' kernels run in interpret mode, as the
JAX tests run them on the CPU (``_rms_call`` / ``_rms2d_bwd``,
``_ln_call`` / ``_ln2d_bwd``), and the differentiable entries against
``jax.vjp`` of ``norms.rms_norm`` / ``norms.layer_norm``, on the same
numpy inputs. 300 rows are not a multiple of the TPU kernels' 256-row
block; 1 row is the smallest ragged block. Each JAX output is built once
per module.

Tolerances: fp32 1e-5 max abs (another summation order in the row
reductions) and dw/db, sums over rows, 1e-5 of their largest value;
bf16 one bf16 ulp of the largest reference value (2**-7 of it) plus
1e-6: both sides round an fp32 result to bf16 once, after sums taken in
another order.

``incubate.nn.functional.fused_rms_norm`` / ``fused_layer_norm`` (with
and without ``bias`` and ``residual``) are held against the JAX
functions on the CPU, where both take the plain composition, within
1e-5 (fp32). The norm backend's switch is checked without a card: its
decision for a CUDA device, and, with the decision forced on, that
``layer_norm`` / ``rms_norm`` take the kernel exactly under the JAX
package's conditions.

On a card (``-m gpu``) each kernel is held against its plain version:
fp32 within 1e-5 (dw/db within 1e-5 of their column's sum of
magnitudes), bf16 within one bf16 rounding of the plain version run in
fp32 on the same inputs.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.incubate.nn import functional as TIF
from paddle_tpu_torch.nn.functional import norm as tnorm
from paddle_tpu_torch.ops.cuda import norms as tn

SHAPES = [(1, 96), (300, 96)]
DTYPES = ["float32", "bfloat16"]
RMS_EPS, LN_EPS = 1e-6, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests share the machine's cores with
    other test workers, and PyTorch's thread pool, spinning on small ops
    against them, slowed these CPU runs by two orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, n, h):
    """x, w, b, g as numpy fp32 (w near one)."""
    rng = np.random.default_rng(seed)
    x, g = rng.normal(size=(2, n, h)).astype(np.float32)
    w, b = rng.normal(size=(2, h)).astype(np.float32)
    return x, 1.0 + 0.1 * w, b, g


def _t(a, dtype):
    return torch.tensor(np.asarray(a, np.float32)).to(getattr(torch, dtype))


def _close(got, want, dtype, what, rel=False):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    big = float(np.abs(want).max())
    if dtype == "bfloat16":
        atol = 2.0 ** -7 * big + 1e-6
    else:
        atol = 1e-5 * big if rel else 1e-5
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)


@pytest.fixture(scope="module")
def jax_kernels():
    """The JAX kernels' outputs for every (shape, dtype), interpret
    mode, built once: ``{(n, h, dtype): {"rms": (o, rstd, dx, dw),
    "ln": (o, mean, rstd, dx, dw, db)}}``; each backward from its own
    forward's saved values."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from paddle_tpu.ops.pallas import norms as jn
    out = {}
    for n, h in SHAPES:
        for dtype in DTYPES:
            jdt = getattr(jnp, dtype)
            x, w, b, g = (jnp.asarray(a, jdt) for a in _inputs(n + h, n, h))
            o, rstd = jn._rms_call(x, w, RMS_EPS, True)
            dx, dw = jn._rms2d_bwd(RMS_EPS, True, (x, w, rstd), g)
            lo, mean, lrstd = jn._ln_call(x, w, b, LN_EPS, True)
            ldx, ldw, ldb = jn._ln2d_bwd(LN_EPS, True, (x, w, mean, lrstd),
                                         g)
            f32 = [np.asarray(a.astype(jnp.float32)) for a in
                   (o, rstd, dx, dw, lo, mean, lrstd, ldx, ldw, ldb)]
            out[(n, h, dtype)] = {"rms": f32[:4], "ln": f32[4:]}
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,h", SHAPES)
def test_rms_plain_versions_match_jax(jax_kernels, n, h, dtype):
    jo, jrstd, jdx, jdw = jax_kernels[(n, h, dtype)]["rms"]
    x, w, _, g = (_t(a, dtype) for a in _inputs(n + h, n, h))
    o, rstd = tn.rms_norm_fwd(x, w, RMS_EPS)
    assert o.dtype == x.dtype and rstd.dtype == torch.float32
    assert tuple(rstd.shape) == (n, 1)
    _close(o.float(), jo, dtype, "out")
    _close(rstd, jrstd, "float32", "rstd")
    # the backward from the JAX forward's saved rstd
    dx, dw = tn.rms_norm_bwd(x, w, torch.tensor(jrstd), g)
    assert dx.dtype == x.dtype and dw.dtype == w.dtype
    _close(dx.float(), jdx, dtype, "dx")
    _close(dw.float(), jdw, dtype, "dw", rel=True)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,h", SHAPES)
def test_layer_plain_versions_match_jax(jax_kernels, n, h, dtype):
    jo, jmean, jrstd, jdx, jdw, jdb = jax_kernels[(n, h, dtype)]["ln"]
    x, w, b, g = (_t(a, dtype) for a in _inputs(n + h, n, h))
    o, mean, rstd = tn.layer_norm_fwd(x, w, b, LN_EPS)
    assert o.dtype == x.dtype
    assert mean.dtype == rstd.dtype == torch.float32
    assert tuple(mean.shape) == tuple(rstd.shape) == (n, 1)
    _close(o.float(), jo, dtype, "out")
    _close(mean, jmean, "float32", "mean")
    _close(rstd, jrstd, "float32", "rstd", rel=True)
    dx, dw, db = tn.layer_norm_bwd(x, w, torch.tensor(jmean),
                                   torch.tensor(jrstd), g)
    assert dx.dtype == x.dtype and dw.dtype == db.dtype == w.dtype
    _close(dx.float(), jdx, dtype, "dx")
    _close(dw.float(), jdw, dtype, "dw", rel=True)
    _close(db.float(), jdb, dtype, "db", rel=True)


@pytest.mark.parametrize("norm", ["rms", "layer"])
def test_differentiable_entries_match_jax_grads(norm):
    """Grads of x, w (and b) through the custom ops against ``jax.vjp``
    of the JAX entries, on ``[3, 100, 96]`` fp32."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from paddle_tpu.ops.pallas import norms as jn
    x, w, b, g = _inputs(11, 300, 96)
    x, g = x.reshape(3, 100, 96), g.reshape(3, 100, 96)
    if norm == "rms":
        jfn = lambda a, c: jn.rms_norm(a, c, eps=RMS_EPS,  # noqa: E731
                                       interpret=True)
        jargs = (x, w)
    else:
        jfn = lambda a, c, d: jn.layer_norm(  # noqa: E731
            a, c, d, eps=LN_EPS, interpret=True)
        jargs = (x, w, b)
    jo, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in jargs))
    jgrads = vjp(jnp.asarray(g))

    targs = [torch.tensor(a).requires_grad_() for a in jargs]
    o = (tn.rms_norm(*targs, eps=RMS_EPS) if norm == "rms"
         else tn.layer_norm(*targs, eps=LN_EPS))
    assert o.shape == (3, 100, 96)
    _close(o.detach(), jo, "float32", "out")
    (o * torch.tensor(g)).sum().backward()
    for name, t, jg in zip(("dx", "dw", "db"), targs, jgrads):
        _close(t.grad, jg, "float32", name, rel=name != "dx")


def test_backend_switch_decision(monkeypatch):
    """The JAX switch, read at each call: a card with
    ``PDTPU_NORM_BACKEND=pallas``. A CPU tensor never takes it."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    monkeypatch.delenv(tnorm.NORM_BACKEND_ENV, raising=False)
    assert not tnorm.norm_backend(cuda)
    monkeypatch.setenv(tnorm.NORM_BACKEND_ENV, "xla")
    assert not tnorm.norm_backend(cuda)
    monkeypatch.setenv(tnorm.NORM_BACKEND_ENV, "pallas")
    assert tnorm.norm_backend(cuda) and not tnorm.norm_backend(cpu)
    assert tnorm.on_card(cuda) and not tnorm.on_card(cpu)


def _spy(monkeypatch):
    calls = []
    for name in ("layer_norm", "rms_norm"):
        real = getattr(tn, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(tn, name, spy)
    return calls


def test_backend_takes_the_kernels_under_jax_conditions(monkeypatch):
    """With the switch forced on (the CPU runs the kernels' plain
    versions): LayerNorm over one axis with weight and bias, RMSNorm over
    the last axis with a weight and no bias take the kernel and match
    the JAX Pallas norms; every other call stays on the plain path, and
    the switch off keeps the plain path."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from paddle_tpu.ops.pallas import norms as jn
    x, w, b, _ = _inputs(5, 6, 96)
    x = x.reshape(2, 3, 96)
    tx, tw, tb = (torch.tensor(a) for a in (x, w, b))
    calls = _spy(monkeypatch)
    monkeypatch.setattr(tnorm, "norm_backend", lambda dev: True)
    out = tnorm.layer_norm(tx, 96, tw, tb)
    assert calls == ["layer_norm"]
    _close(out, jn.layer_norm(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(b), interpret=True),
           "float32", "layer_norm")
    out = tnorm.rms_norm(tx, tw)
    assert calls[-1] == "rms_norm"
    _close(out, jn.rms_norm(jnp.asarray(x), jnp.asarray(w), interpret=True),
           "float32", "rms_norm")
    del calls[:]
    w2 = torch.ones(3, 96)
    tnorm.layer_norm(tx, [3, 96], w2, torch.zeros(3, 96))   # two axes
    tnorm.layer_norm(tx, 96, tw)                            # no bias
    tnorm.layer_norm(tx, 96)
    tnorm.rms_norm(tx, tw, tb)                              # a bias
    tnorm.rms_norm(tx, w2, begin_norm_axis=1)               # two axes
    tnorm.rms_norm(tx)
    assert calls == []
    monkeypatch.setattr(tnorm, "norm_backend", lambda dev: False)
    tnorm.layer_norm(tx, 96, tw, tb)
    tnorm.rms_norm(tx, tw)
    assert calls == []


def test_backend_black_list_under_o2(monkeypatch):
    """Under O2 the norms are black-listed: the kernel gets fp32 rows and
    weights and returns fp32, and the bf16 weight's grad is fp32 (its
    ``main_grad``), as the JAX tape gives it."""
    monkeypatch.setattr(tnorm, "norm_backend", lambda dev: True)
    x = torch.randn(4, 32).to(torch.bfloat16)
    w = torch.nn.Parameter(torch.ones(32, dtype=torch.bfloat16))
    with tamp.auto_cast(level="O2", dtype="bfloat16"):
        out = tnorm.rms_norm(x, w)
    assert out.dtype == torch.float32
    out.sum().backward()
    assert w.grad is None and w.main_grad.dtype == torch.float32
    assert tamp.grad_of(w) is w.main_grad


@pytest.fixture(scope="module")
def jax_incubate():
    pytest.importorskip("jax")
    import paddle_tpu as paddle
    from paddle_tpu.incubate.nn import functional as JIF
    return paddle, JIF


def _incubate_inputs():
    rng = np.random.default_rng(3)
    x, res = rng.normal(size=(2, 2, 4, 5, 48)).astype(np.float32)
    w, nb, b = rng.normal(size=(3, 48)).astype(np.float32)
    return x, 1.0 + 0.1 * w, nb, b, res


@pytest.mark.parametrize("use_bias,use_res", [(False, False), (True, False),
                                              (False, True), (True, True)])
def test_incubate_fused_rms_norm_matches_jax(jax_incubate, use_bias,
                                             use_res):
    paddle, JIF = jax_incubate
    x, w, _, b, res = _incubate_inputs()
    kw = dict(bias=b if use_bias else None,
              residual=res if use_res else None)
    jout, jres = JIF.fused_rms_norm(
        paddle.to_tensor(x), paddle.to_tensor(w), None, 1e-6, -1,
        **{k: None if v is None else paddle.to_tensor(v)
           for k, v in kw.items()})
    out, rout = TIF.fused_rms_norm(
        torch.tensor(x), torch.tensor(w), None, 1e-6, -1,
        **{k: None if v is None else torch.tensor(v)
           for k, v in kw.items()}, quant_scale=0.5)
    _close(out, jout.numpy(), "float32", "out")
    _close(rout, jres.numpy(), "float32", "residual_out")


@pytest.mark.parametrize("use_bias,use_res", [(False, False), (True, True)])
def test_incubate_fused_layer_norm_matches_jax(jax_incubate, use_bias,
                                               use_res):
    paddle, JIF = jax_incubate
    x, w, nb, b, res = _incubate_inputs()
    kw = dict(bias=b if use_bias else None,
              residual=res if use_res else None)
    for args in ((w, nb), (None, None)):
        jout, jres = JIF.fused_layer_norm(
            paddle.to_tensor(x), *(None if a is None else paddle.to_tensor(a)
                                   for a in args), 1e-5, residual_alpha=0.5,
            begin_norm_axis=3,
            **{k: None if v is None else paddle.to_tensor(v)
               for k, v in kw.items()})
        out, rout = TIF.fused_layer_norm(
            torch.tensor(x), *(None if a is None else torch.tensor(a)
                               for a in args), 1e-5, residual_alpha=0.5,
            begin_norm_axis=3,
            **{k: None if v is None else torch.tensor(v)
               for k, v in kw.items()})
        _close(out, jout.numpy(), "float32", f"out {args[0] is None}")
        _close(rout, jres.numpy(), "float32", "residual_out")


def test_incubate_plain_path_over_several_axes(jax_incubate):
    """``begin_norm_axis`` short of the last axis: both packages' plain
    compositions (a norm bias keeps RMS plain too)."""
    paddle, JIF = jax_incubate
    x, w, nb, _, _ = _incubate_inputs()
    w2, nb2 = np.tile(w, 5), np.tile(nb, 5)
    xt = x.reshape(2, 4, 240)
    jout, _ = JIF.fused_layer_norm(paddle.to_tensor(x),
                                   paddle.to_tensor(w2.reshape(5, 48)),
                                   paddle.to_tensor(nb2.reshape(5, 48)),
                                   1e-5, begin_norm_axis=2)
    out, _ = TIF.fused_layer_norm(torch.tensor(x),
                                  torch.tensor(w2.reshape(5, 48)),
                                  torch.tensor(nb2.reshape(5, 48)), 1e-5,
                                  begin_norm_axis=2)
    _close(out, jout.numpy(), "float32", "layer over 2 axes")
    jout, _ = JIF.fused_rms_norm(paddle.to_tensor(xt), paddle.to_tensor(w2),
                                 paddle.to_tensor(nb2), 1e-6, 2)
    out, _ = TIF.fused_rms_norm(torch.tensor(xt), torch.tensor(w2),
                                torch.tensor(nb2), 1e-6, 2)
    _close(out, jout.numpy(), "float32", "rms with a norm bias")


def test_wrappers_refuse_devices_without_a_kernel():
    wrappers = (tn.rms_norm_fwd, tn.rms_norm_bwd, tn.layer_norm_fwd,
                tn.layer_norm_bwd)
    before = [f.launches for f in wrappers]
    m = torch.zeros(4, 16, device="meta")
    v = torch.zeros(16, device="meta")
    s = torch.zeros(4, 1, device="meta")
    for call in (lambda: tn.rms_norm_fwd(m, v),
                 lambda: tn.rms_norm_bwd(m, v, s, m),
                 lambda: tn.layer_norm_fwd(m, v, v),
                 lambda: tn.layer_norm_bwd(m, v, s, s, m)):
        with pytest.raises(ValueError, match="no kernel for device meta"):
            call()
    with pytest.raises(ValueError, match="must be"):
        tn.layer_norm_fwd(torch.zeros(4, 16), torch.zeros(8),
                          torch.zeros(16))
    assert [f.launches for f in wrappers] == before


@pytest.mark.parametrize("wd,bd,want", [
    (torch.bfloat16, torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.float32, torch.float32),
    (torch.bfloat16, torch.float32, torch.float32),
    (torch.float16, torch.float16, torch.float32),
    (torch.bfloat16, None, torch.bfloat16)])
def test_weight_vectors_keep_a_dtype_the_kernels_read(wd, bd, want):
    """The kernels read w and b in their own dtype when both share fp32
    or bf16 (no copy); another dtype, or two, go to fp32."""
    w = torch.arange(8, dtype=torch.float32).to(wd)
    b = None if bd is None else torch.ones(8, dtype=bd)
    dt, wk, bk = tn.weight_vectors(w, b)
    assert dt == want and wk.dtype == want
    assert (wk is w) == (wd == want)
    assert bk is None if b is None else (bk.dtype == want
                                         and torch.equal(bk.float(),
                                                         b.float()))
    assert torch.equal(wk.float(), w.float())


# ------------------------------------------ the Layer backward's plan --
def _largest_h(dtype):
    """The widest row the kernels take with 16-byte loads (the row
    template's 8 chunks a thread of 256)."""
    return 8 * 256 * (16 // dtype.itemsize)


@pytest.mark.parametrize("norm", [tn._RMS, tn._LAYER])
@pytest.mark.parametrize("dtype,h,want", [
    (torch.float32, 64, (1, 1)), (torch.float32, 768, (2, 3)),
    (torch.float32, 1024, (4, 2)), (torch.float32, 4096, (8, 4)),
    (torch.float32, _largest_h(torch.float32), (8, 8)),
    (torch.bfloat16, 64, (1, 1)), (torch.bfloat16, 768, (1, 3)),
    (torch.bfloat16, 1024, (2, 2)), (torch.bfloat16, 4096, (8, 2)),
    (torch.bfloat16, _largest_h(torch.bfloat16), (8, 8))])
def test_ln_bwd_group_picks_the_fewest_warps(dtype, h, want, norm):
    """G is the fewest warps (1, 2, 4, 8) that hold a row with at most 3
    16-byte chunks a lane (24 bf16 or 12 fp32 elements); K the chunks a
    lane then takes; the same rule for both norms. At GPT-124M's 768
    every lane is busy with 3 chunks: one warp a row in bf16, two in
    fp32; at LLaMA-7B's 4096 a row takes all 8 warps, 2 chunks a lane in
    bf16, 4 in fp32."""
    esize = dtype.itemsize
    G, K = tn.ln_bwd_group(h, esize, norm=norm)
    assert (G, K) == want
    chunks = h * esize // 16
    assert chunks <= 32 * G * K                       # the row fits
    if G > 1:                                         # and no fewer do
        assert -(-chunks // (16 * G)) > tn.LN_LANE_MOST
    if h == 768:
        assert chunks == 32 * G * K == 32 * G * 3     # every lane busy


def test_ln_bwd_group_one_element_loads_and_the_limit():
    """Without 16-byte loads (a row not a multiple of 16 bytes, or data
    not aligned) a lane takes at most 8 elements; the widest such row the
    kernels take (2048) fits 8 warps, one more does not."""
    assert tn.ln_bwd_group(203, 4, vec=False) == (1, 8)
    assert tn.ln_bwd_group(768, 2, vec=False) == (4, 6)
    assert tn.ln_bwd_group(2048, 4, vec=False) == (8, 8)
    with pytest.raises(ValueError, match="exceeds"):
        tn.ln_bwd_group(2049, 4, vec=False)
    with pytest.raises(ValueError, match="exceeds"):
        tn.ln_bwd_group(_largest_h(torch.bfloat16) + 8, 2)
    with pytest.raises(ValueError, match="neither RMS"):
        tn.ln_bwd_group(768, 2, norm=2)


def _plan_rows(p, n):
    """Each (CTA, group)'s rows, as the kernel walks them."""
    return {(b, q): list(range(b * p["groups"] + q, n, p["stride"]))
            for b in range(p["ctas"]) for q in range(p["groups"])}


def _column_ranges(ctas, cols, threads=256):
    """Each CTA's ranges of the final sums' columns, and W, their width:
    CTA b takes ranges b, b + ctas, ... of W columns (a power of two from
    8 to 256, at least cols / ctas), as ``slice_sums`` in
    ``csrc/row_norm.cuh`` splits them."""
    W = 8
    while W < threads and W * ctas < cols:
        W *= 2
    return W, [[(c0, min(c0 + W, cols))
                for c0 in range(b * W, cols, ctas * W)]
               for b in range(ctas)]


def _final_sums(part, threads=256):
    """The kernel's column sums of ``part`` [ctas, cols] in fp32 and in
    its order: thread t of a range takes column t % W and rows t // W,
    t // W + 256 / W, ... in order; the threads of a warp on one column
    meet in a shuffle tree, then the warps add in warp order."""
    ctas, cols = part.shape
    W, ranges = _column_ranges(ctas, cols, threads)
    step, lanes = threads // W, max(32 // W, 1)
    out = np.zeros(cols, np.float32)
    for rs in ranges:
        for c0, c1 in rs:
            rows = [np.zeros(c1 - c0, np.float32) for _ in range(step)]
            for r0 in range(step):
                for r in range(r0, ctas, step):
                    rows[r0] = rows[r0] + part[r, c0:c1]
            warps = []
            for w0 in range(0, step, lanes):
                v = rows[w0:w0 + lanes]
                o = lanes // 2
                while o:
                    v = [v[j] + v[j ^ o] for j in range(lanes)]
                    o //= 2
                warps.append(v[0])
            tot = warps[0]
            for v in warps[1:]:
                tot = tot + v
            out[c0:c1] = tot
    return out


@pytest.mark.parametrize("norm", [tn._RMS, tn._LAYER])
@pytest.mark.parametrize("n,h,dtype,sms,cps", [
    (1, 768, torch.bfloat16, 132, 2), (7, 64, torch.float32, 132, 3),
    (8191, 768, torch.bfloat16, 132, 2), (8192, 768, torch.float32, 132, 1),
    (8192, 4096, torch.bfloat16, 132, 2), (300, 1024, torch.float32, 4, 2),
    (100000, 768, torch.bfloat16, 132, 2), (4096, 4096, torch.bfloat16, 132, 3),
    (4096, 4096, torch.float32, 132, 2), (4093, 4096, torch.bfloat16, 132, 4),
    (37, 203, torch.float32, 132, 2)])
def test_ln_bwd_plan_covers_every_row_once(n, h, dtype, sms, cps, norm):
    """Every row is taken by exactly one group; no more CTAs than the
    card holds resident (a cooperative launch), and none without a row;
    the CTAs' column slices of the final sums cover every column once;
    the scratch holds a partial row a CTA: dw and db (2 h floats) for
    LayerNorm, dw alone (h) for RMS, padded to 4."""
    p = tn.ln_bwd_plan(n, h, dtype, sms, cps, norm=norm)
    G, K = tn.ln_bwd_group(h, dtype.itemsize, norm=norm)
    assert (p["G"], p["K"], p["groups"]) == (G, K, 8 // G)
    assert 1 <= p["ctas"] <= sms * cps
    assert p["stride"] == p["ctas"] * p["groups"]
    walks = _plan_rows(p, n)
    rows = sorted(r for rs in walks.values() for r in rs)
    assert rows == list(range(n))
    assert all(any(walks[(b, q)] for q in range(p["groups"]))
               for b in range(p["ctas"]))
    nv = 2 if norm == tn._LAYER else 1
    assert p["cols"] % 4 == 0 and nv * h <= p["cols"] < nv * h + 4
    _, ranges = _column_ranges(p["ctas"], p["cols"])
    cols = sorted(c for rs in ranges for c0, c1 in rs
                  for c in range(c0, c1))
    assert cols == list(range(p["cols"]))
    assert p["part_floats"] == p["ctas"] * p["cols"]


def test_ln_bwd_scratch_is_what_the_plan_needs(monkeypatch):
    """The wrappers' scratch (one per device and stream): at least the
    plan's partial rows; a smaller plan reuses it, a larger one grows
    it."""
    monkeypatch.setattr(tn, "_ln_scratch", {})
    dev = torch.device("cpu")
    small = tn.ln_bwd_plan(8192, 768, torch.bfloat16, 132, 2)
    part = tn.ln_bwd_scratch(dev, 0, small)
    assert part.dtype == torch.float32
    assert part.numel() == small["part_floats"]
    again = tn.ln_bwd_scratch(dev, 0, tn.ln_bwd_plan(64, 768, torch.float32,
                                                     132, 1))
    assert again is part
    big = tn.ln_bwd_plan(8192, 4096, torch.float32, 132, 2)
    grown = tn.ln_bwd_scratch(dev, 0, big)
    assert grown.numel() == big["part_floats"]
    assert tn.ln_bwd_scratch(dev, 1, small) is not grown


@pytest.mark.parametrize("norm", [tn._RMS, tn._LAYER])
@pytest.mark.parametrize("n,h,sms,cps", [(300, 64, 4, 2), (7, 96, 132, 2),
                                         (1000, 40, 3, 3),
                                         (4000, 48, 132, 2)])
def test_ln_bwd_sum_order_gives_the_sums(n, h, sms, cps, norm):
    """A model of the kernel's dw/db (RMS: dw) on its plan, in fp32: each
    group's running sum over its rows, the CTA's groups in order, then
    for each column its threads' running sums over every (256 / W)-th
    CTA, their shuffle tree and the warps in order (:func:`_final_sums`).
    It gives the plain version's sums (fp64 here) within fp32 rounding of
    the column's sum of magnitudes."""
    x, w, b, g = _inputs(n + h, n, h)
    if norm == tn._LAYER:
        mean, rstd = (a.numpy() for a in tn.ln_stats(torch.tensor(x), 1e-5))
        xhat = ((x - mean) * rstd).astype(np.float32)
        sums = np.concatenate([g * xhat, g], axis=1)
    else:
        rstd = tn.rms_stats(torch.tensor(x), 1e-6).numpy()
        xhat = (x * rstd).astype(np.float32)
        sums = g * xhat
    p = tn.ln_bwd_plan(n, h, torch.float32, sms, cps, norm=norm)
    walks = _plan_rows(p, n)
    terms = np.zeros((n, p["cols"]), np.float32)
    terms[:, :sums.shape[1]] = sums
    part = []
    for blk in range(p["ctas"]):
        tot = np.zeros(p["cols"], np.float32)
        for q in range(p["groups"]):
            run = np.zeros(p["cols"], np.float32)
            for r in walks[(blk, q)]:
                run = run + terms[r]
            tot = run if q == 0 else tot + run
        part.append(tot)
    got = _final_sums(np.array(part))
    ref = terms.astype(np.float64).sum(axis=0)
    mag = np.abs(terms.astype(np.float64)).sum(axis=0)
    assert np.all(np.abs(got - ref) <= 1e-6 * mag + 1e-12)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h", [(8192, 768), (8191, 768), (4096, 4096),
                                 (37, 203)])
def test_kernels_match_plain_on_card(cuda, n, h, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)

    def rn(*s):
        return torch.randn(*s, generator=gen, device=cuda)
    x, g = rn(n, h).to(dtype), rn(n, h).to(dtype)
    w, b = (1.0 + 0.1 * rn(h)).to(dtype), rn(h).to(dtype)
    wrappers = (tn.rms_norm_fwd, tn.rms_norm_bwd, tn.layer_norm_fwd,
                tn.layer_norm_bwd)
    before = [f.launches for f in wrappers]
    o, rstd = tn.rms_norm_fwd(x, w, RMS_EPS)
    dx, dw = tn.rms_norm_bwd(x, w, rstd, g)
    lo, mean, lrstd = tn.layer_norm_fwd(x, w, b, LN_EPS)
    ldx, ldw, ldb = tn.layer_norm_bwd(x, w, mean, lrstd, g)
    torch.cuda.synchronize()
    assert [f.launches for f in wrappers] == [c + 1 for c in before]
    f32 = [t.float() for t in (x, w, b, g)]
    ro, rrstd = tn.rms_norm_fwd_plain(f32[0], f32[1], RMS_EPS)
    rdx, rdw = tn.rms_norm_bwd_plain(f32[0], f32[1], rstd, f32[3])
    rlo, rmean, rlrstd = tn.layer_norm_fwd_plain(*f32[:3], LN_EPS)
    rldx, rldw, rldb = tn.layer_norm_bwd_plain(f32[0], f32[1], mean, lrstd,
                                               f32[3])
    bf = dtype == torch.bfloat16

    def lim(ref):
        return 2.0 ** -8 * float(ref.abs().max()) + 1e-6 if bf else 1e-5
    for got, ref in ((o, ro), (rstd, rrstd), (dx, rdx), (lo, rlo),
                     (mean, rmean), (ldx, rldx)):
        assert float((got.float() - ref).abs().max()) <= lim(ref)
    xh = f32[0] * rstd
    lxh = (f32[0] - mean) * lrstd
    for got, ref, terms in ((dw, rdw, f32[3] * xh), (ldw, rldw, f32[3] * lxh),
                            (ldb, rldb, f32[3])):
        tol = lim(ref) if bf else 1e-5 * float(terms.abs().sum(0).max())
        assert float((got.float() - ref).abs().max()) <= tol
    # rstd of the Layer norm: relative, 1 / sqrt(var) can be large
    assert float(((lrstd - rlrstd) / rlrstd).abs().max()) <= 1e-5


@pytest.mark.gpu
def test_repeat_runs_are_bitwise_equal_on_card(cuda):
    """No float atomics: the dw/db sums are in a fixed order. Both
    norms' backwards at GPT-124M's rows (fp32), and at LLaMA-7B's (bf16,
    w bf16) the RMS norm's and the fused residual RMS pair's, with dres
    and without."""
    from paddle_tpu_torch.ops.cuda import fused_residual_norm as tfr
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(8192, 768, generator=gen, device=cuda)
    g = torch.randn(8192, 768, generator=gen, device=cuda)
    w, b = torch.ones(768, device=cuda), torch.zeros(768, device=cuda)
    _, mean, rstd = tn.layer_norm_fwd(x, w, b)
    _, rrstd = tn.rms_norm_fwd(x, w)
    xl, gl, dl = (torch.randn(4096, 4096, generator=gen, device=cuda)
                  .to(torch.bfloat16) for _ in range(3))
    wl = (1.0 + 0.1 * torch.randn(4096, generator=gen, device=cuda)).to(
        torch.bfloat16)
    _, lrstd = tn.rms_norm_fwd(xl, wl)
    for call in (lambda: tn.layer_norm_bwd(x, w, mean, rstd, g),
                 lambda: tn.rms_norm_bwd(x, w, rrstd, g),
                 lambda: tn.rms_norm_bwd(xl, wl, lrstd, gl),
                 lambda: tfr.fused_residual_rms_norm_bwd(xl, wl, lrstd, dl,
                                                         gl),
                 lambda: tfr.fused_residual_rms_norm_bwd(xl, wl, lrstd,
                                                         None, gl)):
        a, c = call(), call()
        assert all(torch.equal(p, q) for p, q in zip(a, c))


@pytest.mark.gpu
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_read_weights_in_their_own_dtype_on_card(cuda, dtype,
                                                         wdtype):
    """Rows and weights of either dtype, mixed (fp32 LayerNorm weights
    beside bf16 rows; bf16 weights beside fp32 rows): the same results
    as the kernels on the weights widened to fp32 (bitwise: a bf16
    weight widens exactly), and dw, db in the weights' dtype."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(8191, 768, generator=gen, device=cuda).to(dtype)
    g = torch.randn(8191, 768, generator=gen, device=cuda).to(dtype)
    w = (1.0 + 0.1 * torch.randn(768, generator=gen, device=cuda)
         ).to(wdtype)
    b = torch.randn(768, generator=gen, device=cuda).to(wdtype)
    o, mean, rstd = tn.layer_norm_fwd(x, w, b, LN_EPS)
    dx, dw, db = tn.layer_norm_bwd(x, w, mean, rstd, g)
    ro, rmean, rrstd = tn.layer_norm_fwd(x, w.float(), b.float(), LN_EPS)
    rdx, rdw, rdb = tn.layer_norm_bwd(x, w.float(), mean, rstd, g)
    ms, rs_ = tn.rms_norm_fwd(x, w, RMS_EPS)
    mdx, mdw = tn.rms_norm_bwd(x, w, rs_, g)
    rms, rrs = tn.rms_norm_fwd(x, w.float(), RMS_EPS)
    rmdx, rmdw = tn.rms_norm_bwd(x, w.float(), rs_, g)
    for got, ref in ((o, ro), (mean, rmean), (rstd, rrstd), (dx, rdx),
                     (ms, rms), (rs_, rrs), (mdx, rmdx)):
        assert torch.equal(got, ref)
    assert dw.dtype == db.dtype == mdw.dtype == wdtype
    for got, ref in ((dw, rdw), (db, rdb), (mdw, rmdw)):
        assert torch.equal(got, ref.to(wdtype))


def _ln_bwd_inputs(cuda, n, h, dtype, wdtype=None, aligned=True, seed=5,
                   norm=tn._LAYER):
    """x, g, w, b on the card (x and g offset by one element, so not
    16-byte aligned, with ``aligned`` False), and the forward's stats
    (mean None for RMS)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def rows():
        flat = torch.randn(n * h + 1, generator=gen, device=cuda).to(dtype)
        return (flat[:-1] if aligned else flat[1:]).view(n, h)
    x, g = rows(), rows()
    w = (1.0 + 0.1 * torch.randn(h, generator=gen, device=cuda)).to(
        wdtype or dtype)
    b = torch.randn(h, generator=gen, device=cuda).to(wdtype or dtype)
    if norm == tn._RMS:
        _, rstd = tn.rms_norm_fwd(x, w, RMS_EPS)
        return x, g, w, None, rstd
    _, mean, rstd = tn.layer_norm_fwd(x, w, b, LN_EPS)
    return x, g, w, mean, rstd


def _norm_bwd(x, w, mean, rstd, g):
    """The backward of the norm whose stats these are (mean None: RMS)."""
    if mean is None:
        return tn.rms_norm_bwd(x, w, rstd, g)
    return tn.layer_norm_bwd(x, w, mean, rstd, g)


def _check_ln_bwd(got, x, w, mean, rstd, g, dres=None):
    """(d, dw, db) (RMS, mean None: (d, dw)) against the plain version in
    fp32 on the same inputs: fp32 within 1e-5 (dw, db within 1e-5 of
    their column's sum of magnitudes), bf16 within one rounding of the
    largest value."""
    f32 = [t.float() for t in (x, w, g)]
    if mean is None:
        (d, dw), db = got, None
        rd, rdw = tn.rms_norm_bwd_plain(f32[0], f32[1], rstd, f32[2])
        rdb = None
        xh = f32[0] * rstd
    else:
        d, dw, db = got
        rd, rdw, rdb = tn.layer_norm_bwd_plain(f32[0], f32[1], mean, rstd,
                                               f32[2])
        xh = (f32[0] - mean) * rstd
    if dres is not None:
        rd = rd + dres.float()
    bf = x.dtype == torch.bfloat16

    def lim(ref):
        return 2.0 ** -8 * float(ref.abs().max()) + 1e-6 if bf else 1e-5
    assert d.dtype == x.dtype and dw.dtype == w.dtype
    assert db is None or db.dtype == w.dtype
    assert float((d.float() - rd).abs().max()) <= lim(rd)
    sums = ((dw, rdw, f32[2] * xh),) + (
        () if db is None else ((db, rdb, f32[2]),))
    for got_, ref, terms in sums:
        tol = (2.0 ** -8 * float(ref.abs().max()) + 1e-6
               if w.dtype == torch.bfloat16 or bf
               else 1e-5 * float(terms.abs().sum(0).max()))
        assert float((got_.float() - ref).abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("norm", [tn._LAYER, tn._RMS])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [64, 768, 1024, 4096, "largest"])
@pytest.mark.parametrize("n", [1, 7, 8191, 8192])
def test_layer_norm_bwd_kernel_matches_plain_on_card(cuda, n, h, dtype,
                                                     norm):
    """The one-launch backward of both norms (rows 16 and 14) at every
    group size the plan picks, ragged and tiny row counts: one launch a
    call, the plain version's results, a second run bitwise equal."""
    h = _largest_h(dtype) if h == "largest" else h
    x, g, w, mean, rstd = _ln_bwd_inputs(cuda, n, h, dtype, norm=norm)
    wrapper = tn.rms_norm_bwd if mean is None else tn.layer_norm_bwd
    before = wrapper.launches
    got = _norm_bwd(x, w, mean, rstd, g)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    _check_ln_bwd(got, x, w, mean, rstd, g)
    again = _norm_bwd(x, w, mean, rstd, g)
    assert all(torch.equal(p, q) for p, q in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("norm", [tn._LAYER, tn._RMS])
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("aligned", [True, False])
def test_layer_norm_bwd_one_element_loads_and_weights_on_card(
        cuda, aligned, wdtype, norm):
    """bf16 rows beside fp32 and bf16 weights, with 16-byte loads and
    without (rows one element off alignment: the one-element path), and
    h 203, for both norms: the plain version's results, bitwise equal on
    a second run."""
    for n, h in ((8191, 768), (37, 203), (4093, 2048)):
        x, g, w, mean, rstd = _ln_bwd_inputs(cuda, n, h, torch.bfloat16,
                                             wdtype, aligned, norm=norm)
        got = _norm_bwd(x, w, mean, rstd, g)
        _check_ln_bwd(got, x, w, mean, rstd, g)
        again = _norm_bwd(x, w, mean, rstd, g)
        assert all(torch.equal(p, q) for p, q in zip(got, again))


@pytest.mark.gpu
def test_backwards_of_no_rows_on_card(cuda):
    """No rows: every norm backward returns the empty sums, dw and db
    zero, and counts no launch (its kernels do not run)."""
    from paddle_tpu_torch.ops.cuda import fused_residual_norm as tfr
    x = torch.empty(0, 768, device=cuda)
    s = torch.empty(0, 1, device=cuda)
    w = torch.ones(768, device=cuda)
    wrappers = (tn.rms_norm_bwd, tn.layer_norm_bwd,
                tfr.fused_residual_rms_norm_bwd,
                tfr.fused_residual_layer_norm_bwd)
    before = [f.launches for f in wrappers]
    got = [tn.rms_norm_bwd(x, w, s, x), tn.layer_norm_bwd(x, w, s, s, x),
           tfr.fused_residual_rms_norm_bwd(x, w, s, None, x),
           tfr.fused_residual_layer_norm_bwd(x, w, s, s, None, x)]
    torch.cuda.synchronize()
    assert [f.launches for f in wrappers] == before
    for out in got:
        assert out[0].shape == (0, 768)
        for t in out[1:]:
            assert t.shape == (768,) and not t.any()
