"""The port's quantization arithmetic and its two kernels' plain versions
against the JAX package.

* ``weight_quantize`` and ``kv_quantize``/``kv_dequantize``: BITWISE
  (the same fp32 division, round half to even, clip), zero columns and
  zero vectors included;
* ``weight_only_matmul`` (plain, on the CPU) against the JAX package's
  ``quant_matmul_jnp`` and its Pallas kernel in interpret mode, with
  bias and leading dims: rtol = atol = 1e-5 (fp32, another summation
  order); with bf16 x within ``quant_matmul.tolerance`` (one bf16 step
  of each rounded value); its x, scale and bias gradients against
  ``jax.vjp`` through the kernel's custom VJP: 1e-5;
* the tensor-core route's arithmetic, emulated (fp32 x as three bf16
  terms, scale after the sum), within ``tolerance`` of the JAX
  reference at K = 4096, and three faulty variants outside it;
* the int8-pool ragged and decode paged attention (plain) against the
  JAX entries in interpret mode with scale pools: 1e-5;
* ``generation.rope_at`` against a JITTED JAX ``rope_at`` (traced
  positions, the float32 angles of the JAX serving programs): 1e-5.

On a card (``-m gpu``) each CUDA kernel is held against its plain
version. JAX is imported inside fixtures, so this file also collects on
the card's machine, where only the ``gpu`` tests run.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import quantization as tq
from paddle_tpu_torch.models.generation import rope_at
from paddle_tpu_torch.ops.cuda.paged_attention import (
    paged_decode_attention, ragged_paged_attention,
    ragged_paged_attention_plain)
from paddle_tpu_torch.ops.cuda import quant_matmul as tqm
from paddle_tpu_torch.ops.cuda.quant_matmul import (quant_matmul_plain,
                                                    weight_only_matmul)

TOL = dict(rtol=1e-5, atol=1e-5)


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
def jq():
    pytest.importorskip("jax")
    from paddle_tpu import quantization
    return quantization


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _weights(seed, k, n, zero_cols=()):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(k, n)) * 0.05).astype(np.float32)
    w[:, list(zero_cols)] = 0.0
    return w


# --------------------------------------------------------- arithmetic --
@pytest.mark.parametrize("k,n,zero_cols", [(64, 48, (5,)), (33, 17, (0, 16)),
                                           (8, 3, ())])
def test_weight_quantize_bitwise(jq, k, n, zero_cols):
    import paddle_tpu as paddle
    w = _weights(k * n, k, n, zero_cols)
    # exact .5 ties of w / scale: round half to even on both sides
    w[1, 1] = 0.0
    jqw, js = jq.weight_quantize(paddle.to_tensor(w))
    qw, s = tq.weight_quantize(torch.tensor(w))
    assert qw.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(qw.numpy(), np.asarray(jqw.numpy()))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js.numpy()))
    for c in zero_cols:
        assert s[c] == 1.0 and not qw[:, c].any()
    jdq = jq.weight_dequantize(jqw, js)
    np.testing.assert_array_equal(tq.weight_dequantize(qw, s).numpy(),
                                  np.asarray(jdq.numpy()))


def test_weight_quantize_rounds_half_to_even():
    w = torch.tensor([[127.0, 2.5, -2.5, 0.5], [1.5, 1.0, 3.5, -0.5]])
    # column absmax: 127, 2.5, 3.5, 0.5 -> scale 1 for column 0
    q, s = tq.weight_quantize(w)
    assert q[1, 0] == 2 and s[0] == 1.0     # 1.5 -> 2 (even)
    w = torch.tensor([[254.0], [5.0], [3.0], [-3.0]])  # scale 2: 2.5, 1.5
    q, s = tq.weight_quantize(w)
    assert s.item() == 2.0 and q[:, 0].tolist() == [127, 2, 2, -2]


def test_kv_quantize_bitwise(jq):
    import jax.numpy as jnp
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32) * 3
    x[1, 2] = 0.0                                  # an all-zero vector
    jqv, jsc = jq.kv_quantize(jnp.asarray(x))
    qv, sc = tq.kv_quantize(torch.tensor(x))
    np.testing.assert_array_equal(qv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))
    assert sc[1, 2] == 1.0 and not qv[1, 2].any()
    np.testing.assert_array_equal(
        tq.kv_dequantize(qv, sc).numpy(),
        np.asarray(jq.kv_dequantize(jqv, jsc)))
    assert tq.KV_QUANT_QMAX == jq.KV_QUANT_QMAX


# ------------------------------------------------------- weight matmul --
MATMUL = {
    # name: (x shape, K, N, bias)
    "decode_m8": ((8, 128), 128, 96, False),
    "odd_k_n_bias": ((3, 70), 70, 33, True),
    "lead_dims_bias": ((2, 5, 64), 64, 40, True),
    "m1": ((1, 48), 48, 130, False),
    "mixed_m40": ((40, 96), 96, 64, True),
}


def _matmul_inputs(name):
    shape, k, n, has_bias = MATMUL[name]
    rng = np.random.default_rng(len(name))
    x = rng.normal(size=shape).astype(np.float32)
    qw = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    s = rng.uniform(0.01, 0.1, size=(n,)).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32) if has_bias else None
    return x, qw, s, b


@pytest.mark.parametrize("name", sorted(MATMUL))
def test_weight_only_matmul_matches_jax(name):
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from paddle_tpu.ops.pallas import quant_matmul as qm
    x, qw, s, b = _matmul_inputs(name)
    jb = None if b is None else jnp.asarray(b)
    ref_jnp = np.asarray(qm.weight_only_matmul(x, qw, s, bias=jb,
                                               impl="jnp"))
    ref_pl = np.asarray(qm.weight_only_matmul(x, qw, s, bias=jb,
                                              impl="pallas_interpret"))
    tb = None if b is None else torch.tensor(b)
    out = weight_only_matmul(torch.tensor(x), torch.tensor(qw),
                             torch.tensor(s), bias=tb)
    assert out.shape == x.shape[:-1] + (qw.shape[1],)
    np.testing.assert_allclose(out.numpy(), ref_jnp, **TOL)
    np.testing.assert_allclose(out.numpy(), ref_pl, **TOL)
    # the transposed view of an [N, K] buffer is the same weight
    view = torch.tensor(np.ascontiguousarray(qw.T)).t()
    np.testing.assert_allclose(
        weight_only_matmul(torch.tensor(x), view, torch.tensor(s),
                           bias=tb).numpy(), ref_jnp, **TOL)


@pytest.fixture(scope="module")
def jqm():
    pytest.importorskip("jax")
    from paddle_tpu.ops.pallas import quant_matmul
    return quant_matmul


@pytest.mark.parametrize("name", sorted(MATMUL))
def test_weight_only_matmul_grad_matches_jax_vjp(jqm, name):
    """x, scale and bias gradients through the port's autograd rule (the
    one the card's launch sits under) against ``jax.vjp`` of the Pallas
    path, which reaches the kernel's custom VJP."""
    import jax
    import jax.numpy as jnp
    x, qw, s, b = _matmul_inputs(name)
    rng = np.random.default_rng(7)
    g = rng.normal(size=x.shape[:-1] + (qw.shape[1],)).astype(np.float32)
    jqw = jnp.asarray(qw)

    def f(x_, s_, *b_):
        return jqm.weight_only_matmul(x_, jqw, s_, bias=b_[0] if b_ else None,
                                      impl="pallas_interpret")

    args = (x, s) + (() if b is None else (b,))
    _, vjp = jax.vjp(f, *map(jnp.asarray, args))
    refs = vjp(jnp.asarray(g))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out = weight_only_matmul(ts[0], torch.tensor(qw), ts[1],
                             bias=ts[2] if b is not None else None)
    out.backward(torch.tensor(g))
    for t, r in zip(ts, refs):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize("name", ["decode_m8", "lead_dims_bias",
                                  "mixed_m40", "odd_k_n_bias"])
def test_weight_only_matmul_bf16_matches_jax(jqm, name):
    """bf16 x: the plain version (the CPU path) against the reference's
    jnp and interpret paths, within one bf16 step of each rounded value
    plus 2e-5 of sum |x| |q| s (``tolerance``)."""
    import jax.numpy as jnp
    x, qw, s, b = _matmul_inputs(name)
    tx = torch.tensor(x).to(torch.bfloat16)
    jx = jnp.asarray(tx.float().numpy()).astype(jnp.bfloat16)
    jb = None if b is None else jnp.asarray(b)
    tb = None if b is None else torch.tensor(b)
    out = weight_only_matmul(tx, torch.tensor(qw), torch.tensor(s), bias=tb)
    assert out.dtype == torch.bfloat16
    lim = tqm.tolerance(tx, torch.tensor(qw), torch.tensor(s), tb).numpy()
    for impl in ("jnp", "pallas_interpret"):
        ref = np.asarray(jqm.weight_only_matmul(jx, qw, s, bias=jb,
                                                impl=impl).astype(jnp.float32))
        assert (np.abs(out.float().numpy() - ref) <= lim).all(), impl


@pytest.mark.parametrize("m,dtype,want", [
    (1, torch.float32, "gemv"), (16, torch.float32, "gemv"),
    (17, torch.float32, "tc"), (128, torch.float32, "tc"),
    (130, torch.float32, "tc"), (4096, torch.float32, "tc"),
    (8, torch.bfloat16, "tc"), (300, torch.bfloat16, "tc"),
    (128, torch.float16, None)])
def test_route_rule(m, dtype, want):
    assert tqm.route(m, dtype) == want


def _tc_emulate(x, qw, s, fault=None):
    """The tensor-core route's arithmetic on the CPU: fp32 x split into
    hi = bf16(x), mid = bf16(x - hi) and lo = bf16(x - hi - mid), the
    three products accumulated in fp32 (each product of a bf16 and an
    int8 is exact), the scale after the sum. ``fault``: "drop_mid" (the
    second plane's product never added), "unsigned" (the int8 weight read
    as unsigned bytes), "drop_last_tile" (the last K stage, 64 wide for
    an fp32 x, never added)."""
    hi = x.to(torch.bfloat16).float()
    mid = (x - hi).to(torch.bfloat16).float()
    lo = (x - hi - mid).to(torch.bfloat16).float()
    q = qw.to(torch.int16)
    q = (q & 0xFF if fault == "unsigned" else q).float()
    if fault == "drop_last_tile":
        q[(x.shape[1] - 1) // 64 * 64:] = 0.0
    acc = hi @ q
    if fault != "drop_mid":
        acc = acc + mid @ q
    return (acc + lo @ q) * s


@pytest.fixture(scope="module")
def tc_case(jqm):
    """M 16, K 4096 (a LLaMA-7B projection's K), N 64, and the JAX
    reference's output, built once."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(16, 4096)).astype(np.float32)
    qw = rng.integers(-127, 128, size=(4096, 64)).astype(np.int8)
    s = rng.uniform(1e-4, 2.1e-3, size=(64,)).astype(np.float32)
    ref = np.asarray(jqm.quant_matmul_jnp(x, qw, s))
    return [torch.tensor(a) for a in (x, qw, s, ref)]


@pytest.mark.parametrize("fault,caught", [(None, False), ("drop_mid", True),
                                          ("unsigned", True),
                                          ("drop_last_tile", True)])
def test_tc_tolerance_holds_split_and_catches_faults(tc_case, fault, caught):
    """``tolerance`` admits the route's own arithmetic (three bf16
    terms) and refuses a dropped mid term, an unsigned reading of the
    weight and a dropped last K stage. (A dropped lo term, at most
    ``2**-18 |x|`` a term, lies below the limit.)"""
    x, qw, s, ref = tc_case
    ratio = float(((_tc_emulate(x, qw, s, fault) - ref).abs()
                   / tqm.tolerance(x, qw, s)).max())
    assert (ratio > 1) == caught, ratio
    if not caught:
        assert ratio < 0.5, ratio


# ------------------------------------------- GEMV: fp32 x, M <= 16 rows --
GEMV_SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000),
               (4099, 1001), (999, 301), (77, 33), (96, 130)]   # (K, N)


@pytest.mark.parametrize("k,n", GEMV_SHAPES)
@pytest.mark.parametrize("sms", [132, 114, 7])
def test_gemv_plan_covers_every_channel_and_k_once(k, n, sms):
    """The GEMV's plan: channel blocks that cover N once, and K-slices of
    whole 64-k blocks, in order, without gap or overlap, as even as they
    divide, as many as fill the SMs (one wave) where K allows."""
    blocks, splits = tqm.gemv_plan(k, n, sms)
    ch = tqm.GEMV_CHANNELS
    assert (blocks - 1) * ch < n <= blocks * ch
    sl = tqm.gemv_slices(k, splits)
    assert len(sl) == splits and sl[0][0] == 0 and sl[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(sl, sl[1:]))
    assert all(k0 < k1 and k0 % tqm.GEMV_BLOCK == 0 for k0, k1 in sl)
    whole = [-(-(k1 - k0) // tqm.GEMV_BLOCK) for k0, k1 in sl]
    assert max(whole) - min(whole) <= 1
    covered = np.zeros(k, dtype=int)
    for k0, k1 in sl:
        covered[k0:k1] += 1
    assert (covered == 1).all()
    if blocks >= sms:
        assert splits == 1
    else:
        assert blocks * splits <= sms
        assert splits == -(-k // tqm.GEMV_BLOCK) or \
            blocks * (splits + 1) > sms


def _gemv_emulate(x, qw, s, b=None, sms=132, fault=None):
    """The GEMV's arithmetic on the CPU: x split into three bf16 planes
    (hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid)), the
    int8 weight exact; each 64-k block's products summed into a fresh
    fp32 accumulator, lo first, then mid, then hi; the blocks added in k
    order into their slice's sum; the slices (``gemv_plan`` /
    ``gemv_slices`` on a card of ``sms`` SMs) added in slice order; then
    the scale and the bias. ``fault``: "drop_mid" (the mid plane's
    products never added) or "lost_split" (a middle slice's sum never
    added)."""
    k, n = qw.shape
    _, splits = tqm.gemv_plan(k, n, sms)
    planes, r = [], x.clone()
    for _ in range(3):
        planes.append(r.to(torch.bfloat16).float())
        r = r - planes[-1]
    hi, mid, lo = planes
    q = qw.float()
    y = torch.zeros(x.shape[0], n)
    for i, (k0, k1) in enumerate(tqm.gemv_slices(k, splits)):
        part = torch.zeros(x.shape[0], n)
        for kb in range(k0, k1, tqm.GEMV_BLOCK):
            ks = slice(kb, min(kb + tqm.GEMV_BLOCK, k1))
            acc = lo[:, ks] @ q[ks]
            if fault != "drop_mid":
                acc = acc + mid[:, ks] @ q[ks]
            part = part + (acc + hi[:, ks] @ q[ks])
        if not (fault == "lost_split" and i == splits // 2):
            y = y + part
    y = y * s
    return y if b is None else y + b


GEMV_EMU = {   # name: (M, K, N, bias); odd K and N, several K-slices
    "m1": (1, 999, 301, False), "m3_bias": (3, 4099, 1001, True),
    "m8": (8, 999, 301, True), "m16": (16, 999, 301, False)}


@pytest.fixture(scope="module")
def gemv_refs(jqm):
    """Each GEMV_EMU case's inputs and the JAX Pallas kernel's output
    (interpret mode), built once."""
    import jax.numpy as jnp
    refs = {}
    for name, (m, k, n, has_b) in GEMV_EMU.items():
        rng = np.random.default_rng(m * 1000 + k)
        x = rng.normal(size=(m, k)).astype(np.float32)
        qw = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
        s = rng.uniform(1e-4, 2.1e-3, size=(n,)).astype(np.float32)
        b = rng.normal(size=(n,)).astype(np.float32) if has_b else None
        ref = np.asarray(jqm.weight_only_matmul(
            x, qw, s, bias=None if b is None else jnp.asarray(b),
            impl="pallas_interpret"))
        refs[name] = [None if a is None else torch.tensor(a)
                      for a in (x, qw, s, b, ref)]
    return refs


@pytest.mark.parametrize("name", sorted(GEMV_EMU))
@pytest.mark.parametrize("fault", [None, "drop_mid", "lost_split"])
def test_gemv_emulation_matches_jax(gemv_refs, name, fault):
    """The GEMV's arithmetic, emulated, against the JAX Pallas kernel in
    interpret mode at M 1, 3, 8 and 16 with odd K and N: within
    ``tolerance`` (below half of it); a dropped mid plane and a lost
    K-slice are refused."""
    x, qw, s, b, ref = gemv_refs[name]
    m, k, n = x.shape[0], qw.shape[0], qw.shape[1]
    assert tqm.route(m, torch.float32) == "gemv"
    assert tqm.gemv_plan(k, n, 132)[1] > 1        # several K-slices
    ratio = float(((_gemv_emulate(x, qw, s, b, fault=fault) - ref).abs()
                   / tqm.tolerance(x, qw, s, b)).max())
    if fault is None:
        assert ratio < 0.5, ratio
    else:
        assert ratio > 1, ratio


def test_weight_only_linear_layer_matches_jax(jq):
    import jax.numpy as jnp

    import paddle_tpu as paddle
    from paddle_tpu.nn.layers import Linear as JLinear
    rng = np.random.default_rng(9)
    w = _weights(1, 24, 20, (3,))
    b = rng.normal(size=(20,)).astype(np.float32)
    x = rng.normal(size=(2, 3, 24)).astype(np.float32)
    jl = JLinear(24, 20)
    jl.weight._write(jnp.asarray(w))
    jl.bias._write(jnp.asarray(b))
    jwl = jq.WeightOnlyLinear(jl)
    lin = torch.nn.Linear(24, 20)
    with torch.no_grad():
        lin.weight.copy_(torch.tensor(w.T))
        lin.bias.copy_(torch.tensor(b))
    wl = tq.WeightOnlyLinear(lin)
    assert wl.qweight.shape == (20, 24) and wl.qweight.is_contiguous()
    np.testing.assert_array_equal(wl.qweight.numpy().T,
                                  np.asarray(jwl.qweight.numpy()))
    np.testing.assert_array_equal(wl.scale.numpy(),
                                  np.asarray(jwl.scale.numpy()))
    ref = np.asarray(jwl(paddle.to_tensor(x)).numpy())
    np.testing.assert_allclose(wl(torch.tensor(x)).detach().numpy(), ref,
                               **TOL)


def test_weight_only_quantize_swaps_every_linear():
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    m = LlamaForCausalLM(LlamaConfig(vocab_size=64, hidden_size=32,
                                     num_layers=2, num_heads=4,
                                     num_kv_heads=2, max_seq_len=32),
                         device="cpu")
    tq.weight_only_quantize(m)
    lin = [n for n, mod in m.named_modules()
           if isinstance(mod, torch.nn.Linear)]
    wol = [n for n, mod in m.named_modules()
           if isinstance(mod, tq.WeightOnlyLinear)]
    assert lin == [] and len(wol) == 7 * 2 + 1
    # min_features skips narrow inputs, as the JAX function does
    m2 = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Linear(8, 2))
    tq.weight_only_quantize(m2, min_features=8)
    assert isinstance(m2[0], torch.nn.Linear)
    assert isinstance(m2[1], tq.WeightOnlyLinear)


def test_unported_quantization_names_its_slice():
    lin = torch.nn.Linear(4, 4)
    for call in (lambda: tq.weight_quantize(torch.ones(4, 4),
                                            algo="weight_only_int4"),
                 lambda: tq.WeightOnlyLinear(lin, algo="weight_only_int4"),
                 lambda: tq.weight_only_quantize(lin,
                                                 algo="weight_only_int4"),
                 lambda: tq.weight_only_linear(torch.ones(1, 4),
                                               torch.ones(4, 4, dtype=torch.int8),
                                               torch.ones(4),
                                               weight_dtype="int4")):
        with pytest.raises(NotImplementedError, match="int4"):
            call()
    for call in (lambda: tq.fake_quant(torch.ones(2), 1.0), tq.QAT, tq.PTQ):
        with pytest.raises(NotImplementedError,
                           match="quantized-training slice"):
            call()


def test_matmul_refusals():
    x, qw, s = torch.ones(2, 4), torch.ones(4, 3, dtype=torch.int8), \
        torch.ones(3)
    with pytest.raises(ValueError, match="K dim"):
        weight_only_matmul(torch.ones(2, 5), qw, s)
    with pytest.raises(TypeError, match="int8"):
        weight_only_matmul(x, qw.float(), s)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        weight_only_matmul(x.to("meta"), qw.to("meta"), s.to("meta"))
    before = weight_only_matmul.launches
    weight_only_matmul(x, qw, s)            # CPU: plain, counts nothing
    assert weight_only_matmul.launches == before


# ----------------------------------------------------- int8 attention --
def _int8_case(seed, kv_lens, q_lens, hq, hk, d, ps, q_block):
    rng = np.random.default_rng(seed)
    B = len(kv_lens)
    npg = [-(-kv // ps) for kv in kv_lens]
    NP = max(npg) + 1
    P = 1 + sum(npg) + 2
    perm = rng.permutation(np.arange(1, P))
    bt = np.zeros((B, NP), np.int32)
    at = 0
    for b in range(B):
        bt[b, :npg[b]] = perm[at:at + npg[b]]
        at += npg[b]
    k = rng.integers(-127, 128, size=(hk, P, ps, d)).astype(np.int8)
    v = rng.integers(-127, 128, size=(hk, P, ps, d)).astype(np.int8)
    ks = rng.uniform(0.002, 0.03, size=(hk, P, ps)).astype(np.float32)
    vs = rng.uniform(0.002, 0.03, size=(hk, P, ps)).astype(np.float32)
    segs = [-(-ql // q_block) * q_block for ql in q_lens]
    starts = np.cumsum([0] + segs[:-1])
    T = sum(segs) + q_block
    q = rng.normal(size=(T, hq, d)).astype(np.float32)
    rows = np.concatenate([np.arange(s, s + n)
                           for s, n in zip(starts, q_lens)])
    return (q, k, v, bt, np.asarray(kv_lens, np.int32),
            np.asarray(q_lens, np.int32), ks, vs, rows)


INT8_CASES = {
    # name: (kv_lens, q_lens, hq, hk, d, page_size, q_block)
    "mixed_qb2": ([13, 6, 21, 1], [5, 1, 9, 1], 4, 4, 16, 8, 2),
    "zero_qlen_slot": ([10, 9, 12], [2, 0, 3], 2, 2, 16, 8, 2),
    "gqa_rep4_page16": ([26, 9, 40], [9, 2, 3], 8, 2, 32, 16, 4),
}


@pytest.mark.parametrize("name", sorted(INT8_CASES))
def test_int8_ragged_matches_jax(name):
    pytest.importorskip("jax")
    from paddle_tpu.ops.pallas import paged_attention as pga
    kv_lens, q_lens, hq, hk, d, ps, qb = INT8_CASES[name]
    q, k, v, bt, kvl, ql, ks, vs, rows = _int8_case(
        5, kv_lens, q_lens, hq, hk, d, ps, qb)
    ref = np.asarray(pga.ragged_paged_attention(
        q, k, v, bt, kvl, ql, q_block=qb, interpret=True, k_scales=ks,
        v_scales=vs))
    args = [torch.tensor(a) for a in (q, k, v, bt, kvl, ql)]
    out = ragged_paged_attention(*args, q_block=qb,
                                 k_scales=torch.tensor(ks),
                                 v_scales=torch.tensor(vs)).numpy()
    np.testing.assert_allclose(out[rows], ref[rows], **TOL)
    assert not out[len(q) - qb:].any()


def test_int8_decode_matches_jax():
    pytest.importorskip("jax")
    from paddle_tpu.ops.pallas import paged_attention as pga
    q, k, v, bt, kvl, _, ks, vs, _ = _int8_case(3, [1, 7, 8, 9, 25],
                                                [1] * 5, 8, 2, 16, 8, 1)
    q = q[:5]
    ref = np.asarray(pga.paged_decode_attention(
        q, k, v, bt, kvl, interpret=True, k_scales=ks, v_scales=vs))
    out = paged_decode_attention(
        *(torch.tensor(a) for a in (q, k, v, bt, kvl)),
        k_scales=torch.tensor(ks), v_scales=torch.tensor(vs)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_int8_attention_refusals():
    q, k, v, bt, kvl, ql, ks, vs, _ = (torch.tensor(a) for a in _int8_case(
        1, [5], [2], 2, 2, 16, 8, 2))
    with pytest.raises(ValueError, match="both k_scales and v_scales"):
        ragged_paged_attention(q, k, v, bt, kvl, ql, q_block=2, k_scales=ks)
    with pytest.raises(TypeError, match="int8 pools take"):
        ragged_paged_attention(q, k, v, bt, kvl, ql, q_block=2)
    with pytest.raises(ValueError, match="k_scales must be"):
        ragged_paged_attention(q, k, v, bt, kvl, ql, q_block=2,
                               k_scales=ks[:, :1], v_scales=vs)


# --------------------------------------------------------------- rope --
@pytest.mark.parametrize("shape,npos", [((3, 1, 4, 16), 3), ((1, 7, 2, 8), 7),
                                        ((2, 1, 4, 16), 1)])
def test_rope_at_matches_jitted_jax(shape, npos):
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from paddle_tpu.models.generation import rope_at as jrope_at
    rng = np.random.default_rng(npos)
    x = rng.normal(size=shape).astype(np.float32)
    pos = rng.integers(0, 4096, size=(npos,)).astype(np.int32)
    for theta in (10000.0, 500000.0):
        ref = jax.jit(lambda a, p, t=theta: jrope_at.raw(a, p, theta=t))(
            jnp.asarray(x), jnp.asarray(pos))
        out = rope_at(torch.tensor(x), torch.tensor(pos).long(), theta)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


# ------------------------------------------------------------- on card --
@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(1, 4096, 4096), (8, 4096, 11008),
                                   (8, 11008, 4096), (16, 96, 130),
                                   (17, 4096, 512), (128, 4096, 4096),
                                   (5, 77, 33), (40, 70, 33)])
def test_weight_only_matmul_kernel_matches_plain(cuda, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(m * 7 + n)
    x = torch.randn(m, k, generator=g, device=cuda)
    qw = torch.randint(-127, 128, (n, k), generator=g, device=cuda,
                       dtype=torch.int8).t()
    s = torch.rand(n, generator=g, device=cuda) * 0.1 + 0.01
    b = torch.randn(n, generator=g, device=cuda)
    before = weight_only_matmul.launches
    out = weight_only_matmul(x, qw, s, bias=b)
    ref = quant_matmul_plain(x, qw, s, bias=b)
    torch.cuda.synchronize()
    assert weight_only_matmul.launches == before + 1
    # fp32, another summation order: 2e-5 of each output's sum of
    # |x| |q| s, plus the bias's rounding
    mag = (x.abs() @ qw.float().abs()) * s + b.abs()
    assert ((out - ref).abs() <= 2e-5 * mag + 1e-6).all()


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n,dtype", [
    (128, 4096, 4096, F32), (128, 11008, 4096, F32), (17, 4096, 512, F32),
    (200, 4096, 1001, F32), (512, 4096, 4096, F32), (130, 4099, 1001, F32),
    (8, 4096, 4096, BF16), (128, 4096, 11008, BF16),
    (128, 11008, 4096, BF16), (8, 4096, 32000, BF16), (40, 4096, 130, BF16),
    (5, 77, 33, BF16)])
def test_weight_only_matmul_tc_route_matches_plain(cuda, m, k, n, dtype):
    """The tensor-core route (every bf16 call; fp32 with M > 16, K
    padded to a multiple of 16) against the plain version within
    ``tolerance``, element by element, and the same bits on a second
    call."""
    g = torch.Generator(device=cuda).manual_seed(m * 13 + n)
    x = torch.randn(m, k, generator=g, device=cuda).to(dtype)
    qw = torch.randint(-127, 128, (n, k), generator=g, device=cuda,
                       dtype=torch.int8).t()
    s = torch.rand(n, generator=g, device=cuda) * 0.002 + 1e-4
    b = torch.randn(n, generator=g, device=cuda)
    assert tqm.route(m, dtype) == "tc"
    before = (weight_only_matmul.launches, weight_only_matmul.tc_launches)
    out = weight_only_matmul(x, qw, s, bias=b)
    ref = quant_matmul_plain(x, qw, s, bias=b)
    torch.cuda.synchronize()
    assert (weight_only_matmul.launches,
            weight_only_matmul.tc_launches) == (before[0] + 1, before[1] + 1)
    assert out.dtype == dtype and out.shape == (m, n)
    lim = tqm.tolerance(x, qw, s, b)
    assert ((out.float() - ref.float()).abs() <= lim).all()
    assert torch.equal(out, weight_only_matmul(x, qw, s, bias=b))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 3, 8, 16])
@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 11008), (11008, 4096),
                                 (4096, 32000), (4099, 1001)])
def test_gemv_matches_plain_on_card(cuda, m, k, n):
    """The GEMV (fp32, M <= 16: the tensor cores' decode route) at the
    LLaMA-7B projections' shapes and an odd K and N against the plain
    version within ``tolerance``, element by element, one launch, none
    on the ``"tc"`` route, and the same bits on a second call."""
    g = torch.Generator(device=cuda).manual_seed(m * 31 + n)
    x = torch.randn(m, k, generator=g, device=cuda)
    qw = torch.randint(-127, 128, (n, k), generator=g, device=cuda,
                       dtype=torch.int8).t()
    s = torch.rand(n, generator=g, device=cuda) * 0.002 + 1e-4
    b = torch.randn(n, generator=g, device=cuda)
    assert tqm.route(m, F32) == "gemv"
    before = (weight_only_matmul.launches, weight_only_matmul.tc_launches)
    out = weight_only_matmul(x, qw, s, bias=b)
    ref = quant_matmul_plain(x, qw, s, bias=b)
    torch.cuda.synchronize()
    assert (weight_only_matmul.launches,
            weight_only_matmul.tc_launches) == (before[0] + 1, before[1])
    assert ((out - ref).abs() <= tqm.tolerance(x, qw, s, b)).all()
    assert torch.equal(out, weight_only_matmul(x, qw, s, bias=b))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_weight_only_matmul_grad_on_card(cuda, dtype):
    """x, scale and bias gradients of the kernel path (M 128: the
    tensor cores) against the plain path's autograd, within
    ``grad_tolerance``."""
    m, k, n = 128, 4096, 1024
    g = torch.Generator(device=cuda).manual_seed(5)
    x0 = torch.randn(m, k, generator=g, device=cuda).to(dtype)
    qw = torch.randint(-127, 128, (n, k), generator=g, device=cuda,
                       dtype=torch.int8).t()
    s0 = torch.rand(n, generator=g, device=cuda) * 0.002 + 1e-4
    b0 = torch.randn(n, generator=g, device=cuda)
    gy = torch.randn(m, n, generator=g, device=cuda).to(dtype)
    got, refs = [], []
    for fn, into in ((weight_only_matmul, got), (quant_matmul_plain, refs)):
        x, s, b = (t.clone().requires_grad_() for t in (x0, s0, b0))
        before = weight_only_matmul.tc_launches
        fn(x, qw, s, bias=b).backward(gy)
        assert weight_only_matmul.tc_launches == before + (
            fn is weight_only_matmul)
        into.extend(t.grad for t in (x, s, b))
    torch.cuda.synchronize()
    for a, r, lim in zip(got, refs, tqm.grad_tolerance(x0, qw, s0, gy, refs)):
        assert a is not None and a.dtype == r.dtype
        assert ((a.float() - r.float()).abs() <= lim).all()


@pytest.mark.gpu
def test_weight_only_linear_backward_on_card(cuda):
    """``loss.backward()`` through a ``WeightOnlyLinear`` on the card
    gives x its gradient (the layer keeps ``scale`` as a buffer)."""
    g = torch.Generator(device=cuda).manual_seed(6)
    lin = torch.nn.Linear(4096, 512, device=cuda)
    wl = tq.WeightOnlyLinear(lin)
    x0 = torch.randn(2, 32, 4096, generator=g, device=cuda)
    gy = torch.randn(2, 32, 512, generator=g, device=cuda)
    x = x0.clone().requires_grad_()
    (wl(x) * gy).sum().backward()
    xr = x0.clone().requires_grad_()
    (quant_matmul_plain(xr, wl.qweight.t(), wl.scale, wl.bias)
     * gy).sum().backward()
    torch.cuda.synchronize()
    assert x.grad is not None and wl.bias.grad is not None
    lim = tqm.grad_tolerance(x0.reshape(64, 4096), wl.qweight.t(), wl.scale,
                             gy.reshape(64, 512), [None] * 3)[0]
    assert ((x.grad - xr.grad).abs().reshape(64, 4096) <= lim).all()


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(INT8_CASES))
def test_int8_attention_kernel_matches_plain(cuda, name):
    kv_lens, q_lens, hq, hk, d, ps, qb = INT8_CASES[name]
    q, k, v, bt, kvl, ql, ks, vs, rows = _int8_case(
        5, kv_lens, q_lens, hq, hk, d, ps, qb)
    args = [torch.tensor(a, device=cuda) for a in (q, k, v, bt, kvl, ql)]
    sc = dict(k_scales=torch.tensor(ks, device=cuda),
              v_scales=torch.tensor(vs, device=cuda))
    before = ragged_paged_attention.launches
    out = ragged_paged_attention(*args, q_block=qb, **sc)
    ref = ragged_paged_attention_plain(*args, q_block=qb, **sc)
    torch.cuda.synchronize()
    assert ragged_paged_attention.launches == before + 1
    np.testing.assert_allclose(out.cpu().numpy()[rows],
                               ref.cpu().numpy()[rows], rtol=2e-5,
                               atol=2e-5)
