"""The port's fused decode kernels (the megakernel decode path) against
the JAX package's.

On the CPU each wrapper runs its plain PyTorch version; the plain
versions are held against the JAX twins (``fused_decode_qkv_twin``,
``fused_decode_mlp_twin``, ``fused_decode_epilogue_twin``: jitted jnp,
the kernels' own reference) on the geometries of
``tests/test_decode_megakernel.py`` (B = 5, rows spanning page
boundaries, the NaN-poison drill), on the same numpy inputs: fp32
values within 1e-5 (abs and rel; another summation order), pool entries
no row writes, tokens and bad flags exactly equal. The JAX weights are
``[in, out]``, the port's ``[out, in]``: the port gets the transposes.

One decode step of the JAX ``_gpt_decode_fused`` (its Pallas kernels in
interpret mode, as the JAX tests run them) is held against the port's
``_gpt_decode_fused`` on the same weights (``load_gpt_from_jax``).

On a card (``-m gpu``) each CUDA kernel is held against its plain
version. JAX is imported inside fixtures, so the file also collects on a
machine without JAX.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM, \
    load_gpt_from_jax
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.ops.cuda import fused_decode_mlp as tm_
from paddle_tpu_torch.ops.cuda import fused_decode_qkv as tq_

TOL = dict(rtol=1e-5, atol=1e-5)
CFG = dict(vocab_size=96, hidden_size=32, num_layers=2, num_heads=4,
           max_seq_len=64)


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
def jx():
    pytest.importorskip("jax")
    from paddle_tpu.ops.pallas import fused_decode_mlp as FM
    from paddle_tpu.ops.pallas import fused_decode_qkv as FQ
    return FQ, FM


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _n(rng, *s):
    return rng.normal(size=s).astype(np.float32)


def _t(a, device="cpu"):
    return torch.tensor(np.ascontiguousarray(a), device=device)


def _qkv_inputs(seed=0, B=5, H=32, nh=4, hd=8, NP=3, ps=4, P=12,
                bias=True):
    """test_decode_megakernel's ``_qkv_case``: B=5 rows at positions
    that cross page boundaries, random (possibly shared) block tables."""
    rng = np.random.default_rng(seed)
    pos = np.asarray([0, 3, 7, 11, 2, 5, 9, 1, 6][:B], np.int64)
    bt = rng.integers(0, P, size=(B, NP)).astype(np.int32)
    x, nw, nb = _n(rng, B, H), _n(rng, H), _n(rng, H)
    w = _n(rng, H, 3 * nh * hd) * 0.05          # JAX [in, out]
    b = _n(rng, 3 * nh * hd) * 0.1
    kp, vp = _n(rng, nh, P, ps, hd), _n(rng, nh, P, ps, hd)
    return dict(x=x, nw=nw, nb=nb if bias else None, w=w,
                b=b if bias else None, pos=pos, bt=bt, kp=kp, vp=vp,
                nh=nh, hd=hd)


def _written(pos, bt, P, ps):
    """[P, ps] mask of the (page, slot) entries some row writes."""
    m = np.zeros((P, ps), bool)
    for b, p in enumerate(pos):
        m[bt[b, min(p // ps, bt.shape[1] - 1)], p % ps] = True
    return m


def _port_qkv(a, device="cpu"):
    kp, vp = _t(a["kp"], device), _t(a["vp"], device)
    q, kp, vp = tq_.fused_decode_qkv(
        _t(a["x"], device), _t(a["nw"], device),
        None if a["nb"] is None else _t(a["nb"], device),
        _t(a["w"].T, device), None if a["b"] is None else _t(a["b"], device),
        _t(a["pos"], device), _t(a["bt"], device), kp, vp, eps=1e-5,
        n_heads=a["nh"], n_kv_heads=a["nh"], head_dim=a["hd"])
    return q, kp, vp


@pytest.mark.parametrize("rows,bias", [(None, True), (2, True),
                                       (None, False)])
def test_qkv_plain_matches_twin(jx, rows, bias):
    import jax.numpy as jnp
    FQ, _ = jx
    a = _qkv_inputs(bias=bias)
    nh, hd = a["nh"], a["hd"]
    jq, jk, jv = FQ.fused_decode_qkv_twin(
        jnp.asarray(a["x"]), jnp.asarray(a["nw"]),
        None if a["nb"] is None else jnp.asarray(a["nb"]),
        [jnp.asarray(a["w"])], [] if a["b"] is None else [jnp.asarray(a["b"])],
        jnp.asarray(a["pos"], jnp.int32), jnp.asarray(a["bt"]),
        jnp.asarray(a["kp"]), jnp.asarray(a["vp"]), norm="layer", eps=1e-5,
        n_heads=nh, n_kv_heads=nh, head_dim=hd, rows=rows)
    q, kp, vp = _port_qkv(a)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), **TOL)
    mask = _written(a["pos"], a["bt"], a["kp"].shape[1], a["kp"].shape[2])
    for got, ref in ((kp.numpy(), np.asarray(jk)),
                     (vp.numpy(), np.asarray(jv))):
        np.testing.assert_array_equal(got[:, ~mask], ref[:, ~mask])
        np.testing.assert_allclose(got[:, mask], ref[:, mask], **TOL)


def _llama_qkv_inputs(seed=0, B=5, H=32, nh=4, hk=2, hd=8, NP=3, ps=4,
                      P=12, int8=False, gpt=False):
    """``_qkv_case`` of tests/test_decode_megakernel.py at the LLaMA shape
    (RMSNorm, three projections without biases, GQA 4 on 2 kv heads, rope
    at theta 1e4) or, with ``gpt``, GPT's (LayerNorm, one fused weight
    and bias, no rope); fp32 pools, or int8 pools and scale pools with
    random bytes (so a stray write shows). Weights in the JAX layout
    ``[in, out]``."""
    rng = np.random.default_rng(seed)
    pos = np.asarray([0, 3, 7, 11, 2, 5, 9, 1, 6][:B], np.int64)
    bt = rng.integers(0, P, size=(B, NP)).astype(np.int32)
    x, nw = _n(rng, B, H), _n(rng, H)
    if gpt:
        hk = nh
        ws = [_n(rng, H, (nh + 2 * hk) * hd) * 0.05]
        bs = [_n(rng, (nh + 2 * hk) * hd) * 0.1]
        nb = _n(rng, H)
    else:
        ws = [_n(rng, H, n * hd) * 0.05 for n in (nh, hk, hk)]
        bs, nb = [], None
    shape = (hk, P, ps, hd)
    if int8:
        pools = [rng.integers(-127, 128, shape).astype(np.int8)
                 for _ in range(2)]
        pools += [rng.uniform(0.01, 0.1, shape[:3]).astype(np.float32)
                  for _ in range(2)]
    else:
        pools = [_n(rng, *shape) for _ in range(2)]
    return dict(x=x, nw=nw, nb=nb, ws=ws, bs=bs, pos=pos, bt=bt,
                pools=pools, nh=nh, hk=hk, hd=hd, gpt=gpt)


def _qkv_kw(a):
    return dict(norm="layer" if a["gpt"] else "rms",
                eps=1e-5 if a["gpt"] else 1e-6, n_heads=a["nh"],
                n_kv_heads=a["hk"], head_dim=a["hd"],
                rope_theta=None if a["gpt"] else 1e4)


def _port_branch_qkv(a, device="cpu", plain=False):
    fn = tq_.fused_decode_qkv_plain if plain else tq_.fused_decode_qkv
    return fn(_t(a["x"], device), _t(a["nw"], device),
              None if a["nb"] is None else _t(a["nb"], device),
              [_t(w.T, device) for w in a["ws"]],
              [_t(b, device) for b in a["bs"]], _t(a["pos"], device),
              _t(a["bt"], device), *[_t(p, device) for p in a["pools"]],
              **_qkv_kw(a))


def _check_pools(got, ref, mask, int8):
    """Pool entries no row writes are untouched; written fp32 values
    within TOL; int8 bytes within one step (a rounding tie of
    ``kv_quantize`` on K/V vectors from another summation order; the
    count of such bytes returned), scales within 1e-6 relative."""
    off = 0
    for i, (g, r) in enumerate(zip(got, ref)):
        g, r = np.asarray(g), np.asarray(r)
        np.testing.assert_array_equal(g[:, ~mask], r[:, ~mask])
        if not int8:
            np.testing.assert_allclose(g[:, mask], r[:, mask], **TOL)
        elif i < 2:
            d = np.abs(g[:, mask].astype(np.int32)
                       - r[:, mask].astype(np.int32))
            assert d.max() <= 1
            off += int((d > 0).sum())
        else:
            np.testing.assert_allclose(g[:, mask], r[:, mask], rtol=1e-6,
                                       atol=0)
    return off


@pytest.mark.parametrize("rows,int8,gpt", [
    (None, False, False), (2, False, False), (None, True, False),
    (2, True, False), (None, True, True)])
def test_qkv_branches_plain_match_twin(jx, rows, int8, gpt):
    """The LLaMA branch (RMSNorm, split q/k/v, GQA 4 on 2, rope at theta
    1e4) over fp32 and int8 pools, and GPT's over int8 pools, against
    the JAX twin: q within 1e-5, pools as :func:`_check_pools` says, and
    not one int8 byte off on these tiny inputs."""
    import jax.numpy as jnp
    FQ, _ = jx
    a = _llama_qkv_inputs(int8=int8, gpt=gpt)
    ref = FQ.fused_decode_qkv_twin(
        jnp.asarray(a["x"]), jnp.asarray(a["nw"]),
        None if a["nb"] is None else jnp.asarray(a["nb"]),
        [jnp.asarray(w) for w in a["ws"]], [jnp.asarray(b) for b in a["bs"]],
        jnp.asarray(a["pos"], jnp.int32), jnp.asarray(a["bt"]),
        *[jnp.asarray(p) for p in a["pools"]], rows=rows, **_qkv_kw(a))
    got = _port_branch_qkv(a)
    assert len(got) == len(ref) == (5 if int8 else 3)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), **TOL)
    P, ps = a["pools"][0].shape[1:3]
    mask = _written(a["pos"], a["bt"], P, ps)
    off = _check_pools([t.numpy() for t in got[1:]], ref[1:], mask, int8)
    assert off == 0


@pytest.mark.parametrize("case", ["with_theta", "rows", "width", "dtype"])
def test_qkv_rope_tables_are_checked(case):
    """Rope tables given with ``rope=`` are refused beside ``rope_theta``
    and when they are not fp32 ``[B, hd]``, before any use; tables from
    ``_rope_tables`` alone give what ``rope_theta`` gives."""
    a = _llama_qkv_inputs()
    B, hd = a["x"].shape[0], a["hd"]
    cos, sin = tgen._rope_tables(torch.as_tensor(a["pos"]), hd, 1e4)
    bad = {"with_theta": ((cos, sin), 1e4),
           "rows": ((cos[:B - 1], sin[:B - 1]), None),
           "width": ((cos[:, :hd // 2], sin[:, :hd // 2]), None),
           "dtype": ((cos.double(), sin.double()), None)}[case]
    kw = _qkv_kw(a)
    args = [_t(a["x"]), _t(a["nw"]), None, [_t(w.T) for w in a["ws"]], [],
            _t(a["pos"]), _t(a["bt"])]
    pools = [_t(p) for p in a["pools"]]
    kw.update(rope=bad[0], rope_theta=bad[1])
    with pytest.raises(ValueError, match="rope"):
        tq_.fused_decode_qkv(*args, *[p.clone() for p in pools], **kw)
    kw.update(rope=(cos, sin), rope_theta=None)
    got = tq_.fused_decode_qkv(*args, *[p.clone() for p in pools], **kw)
    ref = _port_branch_qkv(a)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def _mlp_inputs(seed=1, B=5, H=32, nh=4, hd=8, bias=True):
    rng = np.random.default_rng(seed)
    inter = 4 * H
    d = dict(x=_n(rng, B, H), att=_n(rng, B, nh * hd),
             wo=_n(rng, nh * hd, H) * 0.05, bo=_n(rng, H) * 0.1,
             nw=_n(rng, H), nb=_n(rng, H), w1=_n(rng, H, inter) * 0.05,
             b1=_n(rng, inter) * 0.1, w2=_n(rng, inter, H) * 0.05,
             b2=_n(rng, H) * 0.1)
    if not bias:
        for k in ("bo", "nb", "b1", "b2"):
            d[k] = None
    return d


def _port_mlp(d, device="cpu"):
    t = {k: None if v is None else _t(v.T if k in ("wo", "w1", "w2")
                                      else v, device)
         for k, v in d.items()}
    return tm_.fused_decode_mlp(t["x"], t["att"], t["wo"], t["bo"], t["nw"],
                                t["nb"], t["w1"], t["b1"], t["w2"], t["b2"],
                                eps=1e-5)


@pytest.mark.parametrize("bias", [True, False])
def test_mlp_plain_matches_twin(jx, bias):
    import jax.numpy as jnp
    _, FM = jx
    d = _mlp_inputs(bias=bias)
    j = {k: None if v is None else jnp.asarray(v) for k, v in d.items()}
    ref = FM.fused_decode_mlp_twin(j["x"], j["att"], j["wo"], j["bo"],
                                   j["nw"], j["nb"], j["w1"], j["b1"],
                                   j["w2"], j["b2"], arch="gpt",
                                   norm="layer", eps=1e-5)
    np.testing.assert_allclose(_port_mlp(d).numpy(), np.asarray(ref), **TOL)


def _swiglu_inputs(seed=1, B=5, H=32, nh=4, hd=8):
    """test_decode_megakernel's LLaMA MLP case: no biases, gate w1 and up
    w_up ``[H, I]``, down w2 ``[I, H]`` (JAX layout)."""
    rng = np.random.default_rng(seed)
    inter = 4 * H
    return dict(x=_n(rng, B, H), att=_n(rng, B, nh * hd),
                wo=_n(rng, nh * hd, H) * 0.05, nw=_n(rng, H),
                w1=_n(rng, H, inter) * 0.05, w2=_n(rng, inter, H) * 0.05,
                wu=_n(rng, H, inter) * 0.05)


def _port_swiglu(d, device="cpu", plain=False):
    t = {k: _t(v.T if k in ("wo", "w1", "w2", "wu") else v, device)
         for k, v in d.items()}
    fn = tm_.fused_decode_mlp_plain if plain else tm_.fused_decode_mlp
    return fn(t["x"], t["att"], t["wo"], None, t["nw"], None, t["w1"], None,
              t["w2"], None, t["wu"], arch="llama", norm="rms", eps=1e-6)


@pytest.mark.parametrize("rows", [None, 2])
def test_mlp_llama_plain_matches_twin(jx, rows):
    """``arch="llama"`` (SwiGLU) with ``norm="rms"``, whole batch and the
    rows=2 padded tail of the JAX walk: within 1e-5."""
    import jax.numpy as jnp
    _, FM = jx
    d = _swiglu_inputs()
    j = {k: jnp.asarray(v) for k, v in d.items()}
    ref = FM.fused_decode_mlp_twin(j["x"], j["att"], j["wo"], None, j["nw"],
                                   None, j["w1"], None, j["w2"], None,
                                   w_up=j["wu"], arch="llama", norm="rms",
                                   eps=1e-6, rows=rows)
    np.testing.assert_allclose(_port_swiglu(d).numpy(), np.asarray(ref),
                               **TOL)


# ------------------------------------------- rows 5-6 (the egress kernel) --
# (B, H, A, I, most, gelu): LLaMA-7B's row 6 at TP=2 and row 5, odd
# widths, then GPT-124M's egress (row 5) and its TP=2 partial (row 6)
_EGRESS_PLANS = [
    (8, 4096, 0, 5504, 264, False), (5, 4096, 0, 5504, 264, False),
    (1, 4096, 0, 5504, 264, False), (8, 4096, 0, 5504, 132, False),
    (3, 1024, 0, 1536, 7, False), (9, 32, 0, 64, 264, False),
    (8, 4096, 4096, 11008, 264, False), (1, 4096, 4096, 11008, 264, False),
    (5, 32, 32, 128, 264, False),
    (8, 768, 768, 3072, 264, True), (5, 768, 768, 3072, 264, True),
    (1, 768, 768, 3072, 264, True), (8, 768, 768, 3072, 132, True),
    (8, 768, 0, 1536, 264, True), (1, 768, 0, 1536, 264, True),
    (3, 44, 12, 20, 5, True)]


@pytest.mark.parametrize(
    "B,H,A,I,most,gelu", _EGRESS_PLANS,
    ids=[("gelu-" if g else "") + "-".join(map(str, c[:5]))
         for *c, g in _EGRESS_PLANS])
def test_swiglu_plan_covers_every_column_and_k_once(B, H, A, I, most, gelu):
    """The egress kernel's plan (the plain version of the library's rule;
    A 0: row 6, the partial mode; ``gelu``: GPT's GELU MLP, else LLaMA's
    SwiGLU), each product's K cut into slices of at most 512 (GPT-124M:
    2, 2 and 6), each (column, k) of the out-projection (row 5), first
    and second MLP products taken by exactly one CTA, a column block's
    slices in CTA order ascending and contiguous, every CTA the same
    bytes within one column, no more CTAs than can be resident, and at
    least two columns a block wherever an item is a column pair."""
    plan = tm_.egress_plan_for(B, H, A, I, most, gelu=gelu)
    assert plan["grid"] <= most and B <= plan["rows"] < B + 8
    work = tm_.egress_work(plan, H, A, I)
    assert (plan["S0"] > 0) == (A > 0) and bool(work["out_proj"]) == (A > 0)
    if H == 768 and I == 3072:
        assert (plan["S0"], plan["SA"], plan["SB"]) == (2, 2, 6)
    for name, k, n in (("out_proj", A, H), ("mlp_in", H, I),
                       ("mlp_out", I, H)):
        if not k:
            continue
        seen = np.zeros((n, k), dtype=int)
        blocks = {}
        for cta, k0, k1, n0, n1 in work[name]:
            assert 0 < k1 - k0 <= 4 * tm_.SLICE_Q
            seen[n0:n1, k0:k1] += 1
            blocks.setdefault((n0, n1), []).append((cta, k0, k1))
        assert (seen == 1).all(), name
        for slices in blocks.values():
            assert [c for c, _, _ in slices] == sorted(c for c, _, _ in slices)
            assert slices[0][1] == 0 and slices[-1][2] == k
            assert all(a[2] == b[1] for a, b in zip(slices, slices[1:]))
        widths = {n1 - n0 for n0, n1 in blocks}
        assert max(widths) - min(widths) <= 1
        if name != "mlp_in" or gelu:
            assert min(widths) >= 2 or n < 2


@pytest.mark.parametrize("H,hd,heads", [
    (768, 64, 36), (768, 64, 18), (32, 8, 12), (44, 5, 3), (4096, 128, 96),
    (1028, 16, 2)])
def test_split_plan_covers_every_column_and_k_once(H, hd, heads):
    """The split-K ingress's plan (``split_plan``) and its CTAs' shares
    (``split_work``, the kernel's rule): GPT-124M's heads take 3 slices
    of 256 on one card and on a TP=2 rank; every (column, k) taken by
    exactly one CTA, a head's slices in CTA order ascending and
    contiguous, none empty or longer than ``SPLIT_Q`` float4s (what a
    lane group's registers hold), the fewest that are not."""
    S = tq_.split_plan(H)
    if H == 768:
        assert S == 3
    assert (S - 1) * tq_.SPLIT_Q < H // 4 <= S * tq_.SPLIT_Q
    work = tq_.split_work(H, hd, heads, S)
    assert len(work) == heads * S
    seen = np.zeros((heads * hd, H), dtype=int)
    by_head = {}
    for cta, n0, n1, k0, k1 in work:
        assert 0 < k1 - k0 <= 4 * tq_.SPLIT_Q and n1 - n0 == hd
        seen[n0:n1, k0:k1] += 1
        by_head.setdefault(n0, []).append((cta, k0, k1))
    assert (seen == 1).all()
    for slices in by_head.values():
        assert [c for c, _, _ in slices] == sorted(c for c, _, _ in slices)
        assert slices[0][1] == 0 and slices[-1][2] == H
        assert all(a[2] == b[1] for a, b in zip(slices, slices[1:]))


def _partial_emulate(d, fault=None, arch="llama"):
    """Row 6's arithmetic on the CPU, by the kernel's plan. LLaMA
    (RMSNorm without bias): each gate/up K-slice's sums of (y1 * w)
    against the weights and of y1^2, the slices added in slice order,
    1 / rms times the gate and up sums, silu(g) * u. GPT (LayerNorm with
    its bias, from full-row statistics): each fc1 K-slice's sums of the
    normalised rows against fc1, added in slice order, then b1 and
    gelu_tanh. Then the second product's slices added in slice order.
    ``fault``: "no_rms" (the 1 / rms never applied), "no_b1" (fc1's bias
    never added) or "lost_split" (a second-product slice never added)."""
    gelu = arch == "gpt"
    y1, nw = torch.tensor(d["y1"]), torch.tensor(d["nw"])
    w1, w2 = (torch.tensor(np.ascontiguousarray(d[k].T))
              for k in ("w1", "w2"))
    B, H = y1.shape
    I = w1.shape[0]
    plan = tm_.egress_plan_for(B, H, 0, I, 264, gelu=gelu)
    work = tm_.egress_work(plan, H, 0, I)
    first = {name: [(k0, k1) for _, k0, k1, n0, _ in w if n0 == 0]
             for name, w in work.items() if w}
    if gelu:
        mean = y1.mean(1, keepdim=True)
        var = (y1 * y1).mean(1, keepdim=True) - mean * mean
        xs = (y1 - mean) * torch.rsqrt(var + 1e-5) * nw + torch.tensor(d["nb"])
        g = torch.zeros(B, I)
        for k0, k1 in first["mlp_in"]:
            g = g + xs[:, k0:k1] @ w1[:, k0:k1].t()
        if fault != "no_b1":
            g = g + torch.tensor(d["b1"])
        f = torch.nn.functional.gelu(g, approximate="tanh")
    else:
        wu = torch.tensor(np.ascontiguousarray(d["wu"].T))
        xs = y1 * nw
        g, u, ss = torch.zeros(B, I), torch.zeros(B, I), torch.zeros(B)
        for k0, k1 in first["mlp_in"]:
            g = g + xs[:, k0:k1] @ w1[:, k0:k1].t()
            u = u + xs[:, k0:k1] @ wu[:, k0:k1].t()
            ss = ss + (y1[:, k0:k1] ** 2).sum(1)
        if fault != "no_rms":
            rstd = torch.rsqrt(ss / H + 1e-6).reshape(-1, 1)
            g, u = g * rstd, u * rstd
        f = torch.nn.functional.silu(g) * u
    out = torch.zeros(B, H)
    for i, (k0, k1) in enumerate(first["mlp_out"]):
        if not (fault == "lost_split" and i == 1):
            out = out + f[:, k0:k1] @ w2[:, k0:k1].t()
    return out


@pytest.fixture(scope="module")
def partial_refs(jx):
    """Row 6's inputs for B 8, 5 and 1: LLaMA at H 1024, I 1536 (two
    gate/up and three down K-slices) with the JAX
    ``fused_decode_mlp_partial`` (interpret mode) on each, and GPT-124M's
    TP=2 rank (H 768, I 1536: two fc1 and three fc2 K-slices; LayerNorm
    and fc1 biases) with the JAX ``fused_decode_mlp_partial_twin``,
    built once."""
    import jax.numpy as jnp
    _, FM = jx
    refs = {}
    for B in (8, 5, 1):
        rng = np.random.default_rng(40 + B)
        H, I = 1024, 1536
        d = dict(y1=_n(rng, B, H), nw=1.0 + 0.1 * _n(rng, H),
                 w1=_n(rng, H, I) * 0.02, wu=_n(rng, H, I) * 0.02,
                 w2=_n(rng, I, H) * 0.02)
        ref = FM.fused_decode_mlp_partial(
            jnp.asarray(d["y1"]), jnp.asarray(d["nw"]), None,
            jnp.asarray(d["w1"]), None, jnp.asarray(d["w2"]),
            jnp.asarray(d["wu"]), arch="llama", norm="rms", eps=1e-6,
            interpret=True)
        refs["llama", B] = (d, np.asarray(ref))
        H, I = 768, 1536
        d = dict(y1=_n(rng, B, H), nw=1.0 + 0.1 * _n(rng, H),
                 nb=0.1 * _n(rng, H), w1=_n(rng, H, I) * 0.02,
                 b1=0.1 * _n(rng, I), w2=_n(rng, I, H) * 0.02)
        ref = FM.fused_decode_mlp_partial_twin(
            *(jnp.asarray(d[k]) for k in ("y1", "nw", "nb", "w1", "b1",
                                           "w2")),
            arch="gpt", norm="layer", eps=1e-5)
        refs["gpt", B] = (d, np.asarray(ref))
    return refs


_PARTIAL_CASES = [("llama", None), ("llama", "no_rms"),
                  ("llama", "lost_split"), ("gpt", None), ("gpt", "no_b1"),
                  ("gpt", "lost_split")]


@pytest.mark.parametrize("B", [8, 5, 1])
@pytest.mark.parametrize(
    "arch,fault", _PARTIAL_CASES,
    ids=[("gelu-" if a == "gpt" else "") + str(f) for a, f in _PARTIAL_CASES])
def test_partial_emulation_matches_jax(partial_refs, B, arch, fault):
    """Row 6's arithmetic, emulated, against the JAX kernel (LLaMA: the
    Pallas kernel in interpret mode; GPT: its jitted twin): within TOL
    (2e-5 of the reference's largest value, the card's limit); a
    forgotten 1 / rms or fc1 bias and a lost second-product slice are
    refused."""
    d, ref = partial_refs[arch, B]
    err = float(np.abs(_partial_emulate(d, fault, arch).numpy()
                       - ref).max())
    lim = 2e-5 * float(np.abs(ref).max())
    assert (err <= lim) == (fault is None), (err, lim)


POISON = np.asarray([0.0, 0.0, np.nan, 0.0, 0.0], np.float32)


def test_epilogue_rms_untied_plain_matches_twin(jx):
    """The LLaMA epilogue: RMSNorm and an untied head without bias (JAX
    ``[H, V]``, the port's ``[V, H]``), the NaN-poison drill included."""
    import jax.numpy as jnp
    _, FM = jx
    rng = np.random.default_rng(6)
    B, H, V = 5, 32, 17
    x, nw, wlm = _n(rng, B, H), _n(rng, H), _n(rng, V, H) * 0.05
    jl, jn, jb = FM.fused_decode_epilogue_twin(
        jnp.asarray(x), jnp.asarray(nw), None, jnp.asarray(wlm.T), None,
        jnp.asarray(POISON), norm="rms", eps=1e-6, transpose_lm=False)
    lg, nxt, bad = tm_.fused_decode_epilogue(
        _t(x), _t(nw), None, _t(wlm), None, _t(POISON), norm="rms", eps=1e-6)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(bad.numpy(), np.asarray(jb))
    assert bad.tolist() == [False, False, True, False, False]
    assert int(nxt[2]) == 0


@pytest.mark.parametrize("tied", [True, False])
def test_epilogue_plain_matches_twin_and_poison_drill(jx, tied):
    """Tied head (JAX ``transpose_lm``, ``[V, H]``) and an untied head
    with a bias (JAX ``[H, V]``; the port's ``[V, H]``). A NaN-poisoned
    row is bad with token 0, the others untouched, the logits returned
    pre-poison."""
    import jax.numpy as jnp
    _, FM = jx
    rng = np.random.default_rng(2)
    B, H, V = 5, 32, 17
    x, nw, nb = _n(rng, B, H), _n(rng, H), _n(rng, H)
    wlm = _n(rng, V, H) * 0.05
    blm = None if tied else _n(rng, V) * 0.1
    jl, jn, jb = FM.fused_decode_epilogue_twin(
        jnp.asarray(x), jnp.asarray(nw), jnp.asarray(nb),
        jnp.asarray(wlm if tied else wlm.T),
        None if tied else jnp.asarray(blm), jnp.asarray(POISON),
        norm="layer", eps=1e-5, transpose_lm=tied)
    lg, nxt, bad = tm_.fused_decode_epilogue(
        _t(x), _t(nw), _t(nb), _t(wlm), None if tied else _t(blm),
        _t(POISON), eps=1e-5, transpose_lm=tied)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(bad.numpy(), np.asarray(jb))
    assert bad.tolist() == [False, False, True, False, False]
    assert int(nxt[2]) == 0 and np.isfinite(lg.numpy()).all()
    # nxt and bad are exactly guarded_argmax's on the returned logits
    gn, gb = tgen.guarded_argmax(lg, _t(POISON))
    assert torch.equal(gn, nxt) and torch.equal(gb, bad)


# Row 7 past the earlier kernel's shared-memory ceiling: B 16 and 17 rows
# (17: a second row group of one), an odd vocab, both norms, tied and
# untied with a bias, row B // 2 NaN-poisoned
_EPI_MANY = [(B, norm, tied) for B in (16, 17) for norm in ("layer", "rms")
             for tied in (True, False)]


def _epilogue_inputs(B, norm, tied, H=48, V=37, seed=60):
    rng = np.random.default_rng(seed + B)
    pz = np.zeros(B, np.float32)
    pz[B // 2] = np.nan
    return dict(x=_n(rng, B, H), nw=1.0 + 0.1 * _n(rng, H),
                nb=None if norm == "rms" else 0.1 * _n(rng, H),
                wlm=_n(rng, V, H) * 0.05,
                blm=None if tied else 0.1 * _n(rng, V), pz=pz,
                eps=1e-6 if norm == "rms" else 1e-5)


def _epilogue_twin(FM, d, norm, tied):
    import jax.numpy as jnp
    out = FM.fused_decode_epilogue_twin(
        jnp.asarray(d["x"]), jnp.asarray(d["nw"]),
        None if d["nb"] is None else jnp.asarray(d["nb"]),
        jnp.asarray(d["wlm"] if tied else d["wlm"].T),
        None if tied else jnp.asarray(d["blm"]), jnp.asarray(d["pz"]),
        norm=norm, eps=d["eps"], transpose_lm=tied)
    return tuple(np.asarray(o) for o in out)


# the emulation's geometry: V 37 over two CTAs, B 17 in row groups of 16
# and 1, H 512 in two K-chunks of 256 (a card whose CTAs hold 200 floats a
# row fewer than x's rows whole)
_EMU = dict(B=17, H=512, V=37, sms=4, per_sm=1)


def _emu_plan():
    whole = tm_.epilogue_plan_for(_EMU["B"], _EMU["H"], _EMU["V"],
                                  _EMU["sms"], _EMU["per_sm"])
    return tm_.epilogue_plan_for(_EMU["B"], _EMU["H"], _EMU["V"],
                                 _EMU["sms"], _EMU["per_sm"],
                                 smem_most=whole["smem"] - 4 * 16 * 200)


@pytest.fixture(scope="module")
def epilogue_refs(jx):
    """The JAX ``fused_decode_epilogue_twin`` on each ``_EPI_MANY`` case
    and on the emulation's (``_EMU``, both norms, tied and untied), built
    once."""
    _, FM = jx
    refs = {}
    for B, norm, tied in _EPI_MANY:
        d = _epilogue_inputs(B, norm, tied)
        refs[B, norm, tied] = (d, _epilogue_twin(FM, d, norm, tied))
    for norm in ("layer", "rms"):
        for tied in (True, False):
            d = _epilogue_inputs(_EMU["B"], norm, tied, H=_EMU["H"],
                                 V=_EMU["V"], seed=70)
            refs["emu", norm, tied] = (d, _epilogue_twin(FM, d, norm, tied))
    return refs


@pytest.mark.parametrize("B,norm,tied", _EPI_MANY)
def test_epilogue_many_rows_plain_matches_twin(epilogue_refs, B, norm, tied):
    """Row 7 at 16 and 17 rows (more than the earlier kernel's shared memory
    held at LLaMA-7B's width): the port's epilogue on the CPU against the
    JAX twin, values within 1e-5, tokens and bad flags equal, the
    poisoned row bad with token 0."""
    d, (jl, jn, jb) = epilogue_refs[B, norm, tied]
    lg, nxt, bad = tm_.fused_decode_epilogue(
        _t(d["x"]), _t(d["nw"]), None if d["nb"] is None else _t(d["nb"]),
        _t(d["wlm"]), None if tied else _t(d["blm"]), _t(d["pz"]),
        norm=norm, eps=d["eps"], transpose_lm=tied)
    np.testing.assert_allclose(lg.numpy(), jl, **TOL)
    np.testing.assert_array_equal(nxt.numpy(), jn)
    np.testing.assert_array_equal(bad.numpy(), jb)
    assert bad.tolist() == [r == B // 2 for r in range(B)]
    assert int(nxt[B // 2]) == 0


def _epilogue_emulate(d, norm, tied, fault=None):
    """Row 7's arithmetic on the CPU by the kernel's walk (``_EMU``'s
    plan): x normalised from full-row statistics; each CTA's span, each
    row group, each K-chunk's sums added in chunk order, then the bias;
    each CTA's pick (max, first index, all finite) of every row, merged
    over the CTAs in order, ties to the lower index. ``fault``:
    "lost_chunk" (the second K-chunk never added) or "no_bias" (the
    head's bias never added)."""
    x, nw = torch.tensor(d["x"]), torch.tensor(d["nw"])
    B, H = x.shape
    w = torch.tensor(d["wlm"])
    V = w.shape[0]
    if norm == "rms":
        h = x * torch.rsqrt((x * x).mean(1, keepdim=True) + d["eps"]) * nw
    else:
        mean = x.mean(1, keepdim=True)
        var = (x * x).mean(1, keepdim=True) - mean * mean
        h = (x - mean) * torch.rsqrt(var + d["eps"]) * nw \
            + torch.tensor(d["nb"])
    plan = _emu_plan()
    work = tm_.epilogue_work(plan, B, H, V)
    logits = torch.empty(B, V)
    val = torch.full((B,), -float("inf"))
    idx = torch.full((B,), 2**31 - 1)
    fin = torch.ones(B, dtype=torch.bool)
    pz = torch.tensor(d["pz"]).reshape(-1, 1)
    for _, n0, n1 in work["cols"]:
        for b0, b1 in work["groups"]:
            s = torch.zeros(b1 - b0, n1 - n0)
            for i, (k0, k1) in enumerate(work["chunks"]):
                if not (fault == "lost_chunk" and i == 1):
                    s = s + h[b0:b1, k0:k1] @ w[n0:n1, k0:k1].t()
            if not tied and fault != "no_bias":
                s = s + torch.tensor(d["blm"])[n0:n1]
            logits[b0:b1, n0:n1] = s
        lg = logits[:, n0:n1] + pz
        v, j = lg.max(1)
        better = (v > val) | ((v == val) & (n0 + j < idx))
        val, idx = torch.where(better, v, val), torch.where(better, n0 + j,
                                                             idx)
        fin &= torch.isfinite(lg).all(1)
    return logits, torch.where(fin, idx, 0), ~fin, plan


_EMU_CASES = [(n, t, f) for n in ("layer", "rms") for t in (True, False)
              for f in (None, "lost_chunk")] + [("layer", False, "no_bias")]


@pytest.mark.parametrize(
    "norm,tied,fault", _EMU_CASES,
    ids=[f"{n}-{'tied' if t else 'untied'}-{f}" for n, t, f in _EMU_CASES])
def test_epilogue_emulation_matches_twin(epilogue_refs, norm, tied, fault):
    """Row 7's arithmetic, emulated by the kernel's walk over two K-chunks
    and two row groups, against the JAX twin: logits within TOL (2e-5 of
    the twin's largest value, the card's limit), tokens and bad flags
    equal; a lost K-chunk and a forgotten bias are refused."""
    d, (jl, jn, jb) = epilogue_refs["emu", norm, tied]
    lg, nxt, bad, plan = _epilogue_emulate(d, norm, tied, fault)
    assert plan["chunks"] == 2 and plan["grid"] == 2 and plan["RT"] == 16
    err = float(np.abs(lg.numpy() - jl).max())
    ok = err <= 2e-5 * float(np.abs(jl).max())
    assert ok == (fault is None), err
    if fault is None:
        np.testing.assert_array_equal(nxt.numpy(), jn)
        np.testing.assert_array_equal(bad.numpy(), jb)


@pytest.mark.parametrize("B", [1, 5, 8, 16, 17, 32, 64])
@pytest.mark.parametrize("H,V", [(768, 50304), (4096, 32000),
                                 (8192, 128256)])
def test_epilogue_plan_covers_every_column_row_and_k_once(B, H, V):
    """Row 7's plan on an H100 (132 SMs, as many CTAs an SM as their
    shared memory lets be resident, at most 2): every vocab column in
    exactly one CTA's span (spans of equal columns +-1) and one warp's
    unit, every row in one group, K cut into chunks of whole 128-float
    stages, a CTA's shared memory within 227 KB at any B; x's rows held
    whole at the serving widths up to 8 rows of LLaMA-7B and 16 of
    GPT-124M."""
    plan = tm_.epilogue_plan_for(B, H, V, 132, 1)
    per_sm = min(2, 228 * 1024 // (plan["smem"] + 1024))
    if per_sm > 1:
        plan = tm_.epilogue_plan_for(B, H, V, 132, per_sm)
    assert plan["smem"] <= 227 * 1024
    work = tm_.epilogue_work(plan, B, H, V)
    for key in ("cols", "units"):
        spans = [(u[-2], u[-1]) for u in work[key]]
        assert [a for a, _ in spans][1:] == [b for _, b in spans][:-1]
        assert spans[0][0] == 0 and spans[-1][1] == V
    sizes = [n1 - n0 for _, n0, n1 in work["cols"]]
    assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1
    assert max(b - a for *_, a, b in work["units"]) == \
        tm_.epilogue_group(plan["RT"]) <= 64 // plan["RT"]
    assert len(work["cols"]) == plan["grid"] <= 132 * plan["per_sm"]
    for key, n in (("groups", B), ("chunks", H)):
        parts = work[key]
        assert parts[0][0] == 0 and parts[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
    assert len(work["groups"]) == -(-B // plan["RT"]) and plan["RT"] <= 16
    assert all((k1 - k0) % 128 == 0 or k1 == H for k0, k1 in work["chunks"])
    if (H == 4096 and B <= 8) or (H == 768 and B <= 16):
        assert plan["chunks"] == 1


def _step_inputs(seed=3, P=14, ps=8, NP=4):
    """One decode step over 3 slots of random pools: slot 0 at position
    6, slot 1 idle (position 0, its table row the null page), slot 2 at
    position 10 (across a page boundary), slot 2's guard lane poisoned."""
    rng = np.random.default_rng(seed)
    pools = [_n(rng, 4, P, ps, 8) for _ in range(4)]
    bt = (rng.permutation(np.arange(1, P))[:3 * NP]
          .reshape(3, NP).astype(np.int32))
    bt[1] = 0
    tok = np.asarray([[17], [0], [42]], np.int64)
    pos = np.asarray([6, 0, 10], np.int64)
    poison = np.asarray([0.0, 0.0, np.nan], np.float32)
    return pools, bt, tok, pos, poison


def test_decode_step_matches_jax(serving_gpt):
    """The slice at the step level: one megakernel decode step of the JAX
    package (Pallas interpret) and of the port (plain versions) on the
    same weights and pools: logits 1e-5, tokens and bad flags exact,
    pools after the step 1e-5. The fused path reads exactly the
    parameters the JAX one reads."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import paddle_tpu as paddle
    from paddle_tpu.core.tensor import Tensor
    from paddle_tpu.models.generation import _gpt_decode_fused as j_step

    named = {k: np.asarray(v.numpy())
             for k, v in serving_gpt.state_dict().items()}
    tm = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    load_gpt_from_jax(tm, named)
    pools, bt, tok, pos, poison = _step_inputs()

    def jt(a):
        return Tensor(jnp.asarray(a))

    with paddle.no_grad():
        jl, jn, jb, jc = j_step(serving_gpt, jt(tok.astype(np.int32)),
                                jt(pos.astype(np.int32)), jt(bt),
                                [jt(p) for p in pools], jt(poison))
    with torch.no_grad():
        tl, tn, tb, tc = tgen._gpt_decode_fused(
            tm, _t(tok), _t(pos), _t(bt), [_t(p) for p in pools],
            _t(poison))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl.numpy()), **TOL)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn.numpy()))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb.numpy()))
    assert tb.tolist() == [False, False, True]
    for j, t in zip(jc, tc):
        np.testing.assert_allclose(t.numpy(), np.asarray(j.numpy()), **TOL)


def test_fused_step_reads_the_jax_parameters():
    """Every parameter ``_gpt_decode_fused`` reads in JAX (ln1, attn.qkv,
    attn.proj, ln2, mlp.fc1/fc2, ln_f, tied wte) has its port twin on
    the port's path: changing any one of them changes the port's step."""
    gen = torch.Generator().manual_seed(0)
    m = GPTForCausalLM(GPTConfig(**CFG), device="cpu", generator=gen)
    pools, bt, tok, pos, _ = _step_inputs()
    zero = torch.zeros(3)

    def step():
        with torch.no_grad():
            lg, *_ = tgen._gpt_decode_fused(
                m, _t(tok), _t(pos), _t(bt), [_t(p) for p in pools], zero)
        return lg

    base = step()
    read = ["gpt.wte.weight", "gpt.wpe.weight", "gpt.ln_f.weight",
            "gpt.ln_f.bias"]
    for i in range(2):
        read += [f"gpt.blocks.{i}.{n}" for n in (
            "ln1.weight", "ln1.bias", "attn.qkv.weight", "attn.qkv.bias",
            "attn.proj.weight", "attn.proj.bias", "ln2.weight", "ln2.bias",
            "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight",
            "mlp.fc2.bias")]
    params = dict(m.named_parameters())
    assert sorted(read) == sorted(params)
    for name in read:
        p = params[name]
        keep = p.detach().clone()
        with torch.no_grad():
            p.add_(0.5)
        assert not torch.equal(step(), base), name
        with torch.no_grad():
            p.copy_(keep)


# ---------------------------------------------------------------- card --
@pytest.mark.gpu
@pytest.mark.parametrize("B,bias", [(5, True), (9, False)])
def test_qkv_kernel_matches_plain_on_card(cuda, B, bias):
    a = _qkv_inputs(B=B, bias=bias)
    before = tq_.fused_decode_qkv.launches
    q, kp, vp = _port_qkv(a, cuda)
    torch.cuda.synchronize()
    assert tq_.fused_decode_qkv.launches == before + 1
    rq, rk, rv = tq_.fused_decode_qkv_plain(
        _t(a["x"], cuda), _t(a["nw"], cuda),
        None if a["nb"] is None else _t(a["nb"], cuda), _t(a["w"].T, cuda),
        None if a["b"] is None else _t(a["b"], cuda), _t(a["pos"], cuda),
        _t(a["bt"], cuda), _t(a["kp"], cuda), _t(a["vp"], cuda), eps=1e-5,
        n_heads=a["nh"], n_kv_heads=a["nh"], head_dim=a["hd"])
    torch.testing.assert_close(q, rq, **TOL)
    # every pool entry, those that rows sharing a (page, slot) write too:
    # the later row's value stays, as in the plain version
    torch.testing.assert_close(kp, rk, **TOL)
    torch.testing.assert_close(vp, rv, **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("B,bias", [(5, True), (9, False)])
def test_mlp_kernel_matches_plain_on_card(cuda, B, bias):
    d = _mlp_inputs(B=B, bias=bias)
    before = tm_.fused_decode_mlp.launches
    out = _port_mlp(d, cuda)
    torch.cuda.synchronize()
    assert tm_.fused_decode_mlp.launches == before + 1
    torch.testing.assert_close(out, _port_mlp(d).to(cuda), **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("V", [17, 1000])
def test_epilogue_kernel_matches_plain_on_card(cuda, V):
    rng = np.random.default_rng(4)
    B, H = 5, 32
    args = [_t(a, cuda) for a in (_n(rng, B, H), _n(rng, H), _n(rng, H),
                                  _n(rng, V, H) * 0.05)]
    pz = _t(POISON, cuda)
    before = tm_.fused_decode_epilogue.launches
    for _ in range(2):   # the ticket resets between launches
        lg, nxt, bad = tm_.fused_decode_epilogue(*args, None, pz, eps=1e-5,
                                                 transpose_lm=True)
        torch.cuda.synchronize()
        rl, rn, rb = tm_.fused_decode_epilogue_plain(
            *args, None, pz, eps=1e-5, transpose_lm=True)
        torch.testing.assert_close(lg, rl, **TOL)
        assert torch.equal(nxt, rn) and torch.equal(bad, rb)
    assert tm_.fused_decode_epilogue.launches == before + 2
    assert bad.tolist() == [False, False, True, False, False]


@pytest.mark.gpu
@pytest.mark.parametrize("int8,gpt,B", [(False, False, 5), (True, False, 5),
                                        (True, True, 5), (True, False, 9)])
def test_qkv_heads_kernel_matches_plain_on_card(cuda, int8, gpt, B):
    """The LLaMA branch (the per-head kernel) and GPT's over int8 pools
    (the split-K kernel) against the plain version: q within 1e-5, pools as
    :func:`_check_pools` says; rows sharing a (page, slot) keep the later
    row's value, as in the plain version."""
    a = _llama_qkv_inputs(B=B, P=40, int8=int8, gpt=gpt)
    before = tq_.fused_decode_qkv.launches
    got = _port_branch_qkv(a, cuda)
    torch.cuda.synchronize()
    assert tq_.fused_decode_qkv.launches == before + 1
    ref = _port_branch_qkv(a, cuda, plain=True)
    torch.testing.assert_close(got[0], ref[0], **TOL)
    P, ps = a["pools"][0].shape[1:3]
    mask = _written(a["pos"], a["bt"], P, ps)
    _check_pools([t.cpu().numpy() for t in got[1:]],
                 [t.cpu().numpy() for t in ref[1:]], mask, int8)


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True])
def test_qkv_shared_slot_keeps_later_row_on_card(cuda, int8):
    """GPT's ingress (the split-K kernel) with rows 1 and 3 at one (page,
    slot), over fp32 and int8 pools: every pool entry as
    :func:`_check_pools` says against the plain version, and the shared
    entry bitwise what the kernel writes for row 3 alone (row 1 moved to
    another page)."""
    a = _llama_qkv_inputs(B=5, P=40, int8=int8, gpt=True)
    a["pos"][3], a["bt"][3] = a["pos"][1], a["bt"][1]
    ps = a["pools"][0].shape[2]
    pi = min(a["pos"][1] // ps, a["bt"].shape[1] - 1)
    page, slot = int(a["bt"][1, pi]), int(a["pos"][1] % ps)
    got = _port_branch_qkv(a, cuda)
    ref = _port_branch_qkv(a, cuda, plain=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], ref[0], **TOL)
    mask = _written(a["pos"], a["bt"], *a["pools"][0].shape[1:3])
    _check_pools([t.cpu().numpy() for t in got[1:]],
                 [t.cpu().numpy() for t in ref[1:]], mask, int8)
    spare = int(np.setdiff1d(np.arange(40), a["bt"])[0])
    a["bt"][1, pi] = spare
    alone = _port_branch_qkv(a, cuda)
    for g, r in zip(got[1:], alone[1:]):
        assert torch.equal(g[:, page, slot], r[:, page, slot])
    assert not torch.equal(got[1][:, page, slot], alone[1][:, spare, slot])


@pytest.mark.gpu
@pytest.mark.parametrize("B", [8, 5, 1])
@pytest.mark.parametrize("int8", [False, True])
def test_qkv_split_gpt124m_matches_plain_on_card(cuda, B, int8):
    """The split-K ingress at GPT-124M's shapes (x [B, 768], the fused
    [2304, 768] weight and bias, pools [12, 65, 16, 64]) over fp32 and
    int8 pools: one launch on the split kernel, q and the pools within
    2e-5 of the plain version's largest value (int8 bytes within one
    step, scales within 1e-6 relative), the same bits on a second call."""
    g = torch.Generator(device=cuda).manual_seed(30 + B)

    def rn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=cuda) * std

    H, nh, hd, P, ps = 768, 12, 64, 65, 16
    x, nw, nb = rn(B, H), 1.0 + rn(H, std=0.1), rn(H, std=0.1)
    w, b = rn(3 * H, H, std=0.02), rn(3 * H, std=0.02)
    pos = torch.arange(B, device=cuda) * 13    # within the tables' 8 pages
    bt = torch.randperm(P - 1, generator=g, device=cuda)[:B * 8].reshape(
        B, 8).to(torch.int32) + 1
    if int8:
        pools = [torch.randint(-127, 128, (nh, P, ps, hd), generator=g,
                               device=cuda, dtype=torch.int8)
                 for _ in range(2)]
        pools += [torch.rand(nh, P, ps, generator=g, device=cuda) * 0.1
                  + 0.01 for _ in range(2)]
    else:
        pools = [rn(nh, P, ps, hd) for _ in range(2)]
    kw = dict(eps=1e-5, n_heads=nh, n_kv_heads=nh, head_dim=hd)
    before = (tq_.fused_decode_qkv.launches,
              tq_.fused_decode_qkv.split_launches)
    mine = [t.clone() for t in pools]
    got = tq_.fused_decode_qkv(x, nw, nb, w, b, pos, bt, *mine, **kw)
    ref = tq_.fused_decode_qkv_plain(x, nw, nb, w, b, pos, bt,
                                     *[t.clone() for t in pools], **kw)
    again = [t.clone() for t in pools]
    got2 = tq_.fused_decode_qkv(x, nw, nb, w, b, pos, bt, *again, **kw)
    torch.cuda.synchronize()
    assert (tq_.fused_decode_qkv.launches,
            tq_.fused_decode_qkv.split_launches) == (before[0] + 2,
                                                     before[1] + 2)
    lim = 2e-5 * float(ref[0].abs().max())
    assert float((got[0] - ref[0]).abs().max()) <= lim
    mask = np.zeros((P, ps), bool)
    for r in range(B):
        mask[int(bt[r, int(pos[r]) // ps]), int(pos[r]) % ps] = True
    _check_pools([t.cpu().numpy() for t in got[1:]],
                 [t.cpu().numpy() for t in ref[1:]], mask, int8)
    for t, t2 in zip(got, got2):
        assert torch.equal(t, t2)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [8, 5, 1])
@pytest.mark.parametrize("partial", [False, True])
def test_gelu_egress_gpt124m_matches_plain_on_card(cuda, B, partial):
    """The GELU egress at GPT-124M's shapes (row 5: wo [768, 768], fc1
    [3072, 768], fc2 [768, 3072]; row 6, a TP=2 rank: fc1 [1536, 768],
    fc2 [768, 1536]): one launch by the library's plan (the plain rule's
    at its CTAs), within 2e-5 of the plain version's largest value, the
    same bits on a second call."""
    g = torch.Generator(device=cuda).manual_seed(20 + B)

    def rn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=cuda) * std

    H = 768
    I = 1536 if partial else 3072
    plan = tm_.egress_plan(B, H, 0 if partial else H, I, cuda, gelu=True)
    assert plan == tm_.egress_plan_for(B, H, 0 if partial else H, I,
                                       plan["most"], gelu=True)
    nw, nb = 1.0 + rn(H, std=0.1), rn(H, std=0.1)
    w1, b1, w2 = rn(I, H, std=0.02), rn(I, std=0.02), rn(H, I, std=0.003)
    if partial:
        fn, plain = (tm_.fused_decode_mlp_partial,
                     tm_.fused_decode_mlp_partial_plain)
        args = (rn(B, H), nw, nb, w1, b1, w2)
    else:
        fn, plain = tm_.fused_decode_mlp, tm_.fused_decode_mlp_plain
        args = (rn(B, H), rn(B, H), rn(H, H, std=0.003), rn(H, std=0.02),
                nw, nb, w1, b1, w2, rn(H, std=0.02))
    before = (fn.launches, fn.gelu_launches)
    out = fn(*args, eps=1e-5)
    ref = plain(*args, eps=1e-5)
    torch.cuda.synchronize()
    assert (fn.launches, fn.gelu_launches) == (before[0] + 1, before[1] + 1)
    assert float((out - ref).abs().max()) <= 2e-5 * float(ref.abs().max())
    assert torch.equal(out, fn(*args, eps=1e-5))


@pytest.mark.gpu
@pytest.mark.parametrize("B", [5, 9])
def test_mlp_llama_kernel_matches_plain_on_card(cuda, B):
    d = _swiglu_inputs(B=B)
    before = tm_.fused_decode_mlp.launches
    out = _port_swiglu(d, cuda)
    torch.cuda.synchronize()
    assert tm_.fused_decode_mlp.launches == before + 1
    torch.testing.assert_close(out, _port_swiglu(d, cuda, plain=True), **TOL)


@pytest.mark.gpu
def test_epilogue_rms_kernel_matches_plain_on_card(cuda):
    rng = np.random.default_rng(7)
    B, H, V = 5, 32, 1000
    x, nw, wlm = (_t(a, cuda) for a in (_n(rng, B, H), _n(rng, H),
                                        _n(rng, V, H) * 0.05))
    pz = _t(POISON, cuda)
    lg, nxt, bad = tm_.fused_decode_epilogue(x, nw, None, wlm, None, pz,
                                             norm="rms", eps=1e-6)
    torch.cuda.synchronize()
    rl, rn, rb = tm_.fused_decode_epilogue_plain(
        x, nw, None, wlm, None, pz, norm="rms", eps=1e-6, transpose_lm=False)
    torch.testing.assert_close(lg, rl, **TOL)
    assert torch.equal(nxt, rn) and torch.equal(bad, rb)
    assert bad.tolist() == [False, False, True, False, False]


def _epilogue_card(dev, B, H, V, norm, seed=0):
    """Row 7's inputs at a model's widths on the card: LLaMA-7B's RMSNorm
    and untied head, or GPT-124M's LayerNorm with bias and tied head."""
    g = torch.Generator(device=dev).manual_seed(seed + B)

    def rn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=dev) * std

    x, nw = rn(B, H), 1.0 + rn(H, std=0.1)
    nb = None if norm == "rms" else rn(H, std=0.1)
    kw = (dict(norm="rms", eps=1e-6) if norm == "rms"
          else dict(eps=1e-5, transpose_lm=True))
    return [x, nw, nb, rn(V, H, std=0.02)], kw


def _plain_epilogue(args, pz, kw):
    kw = dict(kw)
    kw.setdefault("transpose_lm", False)
    return tm_.fused_decode_epilogue_plain(*args, None, pz, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,V,norm", [(16, 4096, 32000, "rms"),
                                        (32, 4096, 32000, "rms"),
                                        (8, 768, 50304, "layer")])
def test_epilogue_many_rows_matches_plain_on_card(cuda, B, H, V, norm):
    """Row 7 by the library's plan (the plain rule's at its resident CTAs)
    at LLaMA-7B's width with 16 and 32 rows (K-chunks; 32 in two row
    groups) and at GPT-124M's: one launch a call, logits within 2e-5 of
    the plain version's largest value, tokens and bad flags equal but on
    near ties (plain logits within 1e-4), the same bits on a second
    call."""
    args, kw = _epilogue_card(cuda, B, H, V, norm)
    plan = tm_.epilogue_plan(B, H, V, norm, cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert plan == tm_.epilogue_plan_for(B, H, V, sms, plan["per_sm"])
    pz = torch.zeros(B, device=cuda)
    pz[B // 2] = float("nan")
    before = tm_.fused_decode_epilogue.launches
    lg, nxt, bad = tm_.fused_decode_epilogue(*args, None, pz, **kw)
    torch.cuda.synchronize()
    assert tm_.fused_decode_epilogue.launches == before + 1
    rl, rn, rb = _plain_epilogue(args, pz, kw)
    assert float((lg - rl).abs().max()) <= 2e-5 * float(rl.abs().max())
    assert torch.equal(bad, rb) and bad.tolist() == [r == B // 2
                                                     for r in range(B)]
    for r in torch.nonzero(nxt != rn).flatten().tolist():
        assert float((rl[r, rn[r]] - rl[r, nxt[r]]).abs()) < 1e-4, r
    again = tm_.fused_decode_epilogue(*args, None, pz, **kw)
    assert all(torch.equal(a, b) for a, b in zip((lg, nxt, bad), again))


@pytest.mark.gpu
def test_epilogue_plans_sharing_a_kernel_keep_launching_on_card(cuda):
    """B 8 and B 5 at LLaMA-7B's width run one kernel (8 rows a group)
    with different shared memory: after B 5's plan is made, B 8's launch
    still runs and still matches the plain version."""
    H, V = 4096, 4099
    before = tm_.fused_decode_epilogue.launches
    for B in (8, 5, 8):
        args, kw = _epilogue_card(cuda, B, H, V, "rms", seed=11)
        pz = torch.zeros(B, device=cuda)
        lg, nxt, bad = tm_.fused_decode_epilogue(*args, None, pz, **kw)
        rl, rn, rb = _plain_epilogue(args, pz, kw)
        torch.cuda.synchronize()
        assert float((lg - rl).abs().max()) <= 2e-5 * float(rl.abs().max())
        assert torch.equal(bad, rb) and not bad.any()
    assert tm_.fused_decode_epilogue.launches == before + 3


@pytest.mark.gpu
@pytest.mark.parametrize("B", [8, 16])
def test_epilogue_tie_across_ctas_picks_lower_index_on_card(cuda, B):
    """Two equal weight rows in the spans of two CTAs (the first and the
    last), larger than any other logit of every row: the kernel's logits
    of the two are equal bits and every row picks the lower index."""
    H, V = 4096, 32000
    args, kw = _epilogue_card(cuda, B, H, V, "rms", seed=3)
    x, nw, _, w = args
    x.copy_(x[:1] + 0.1 * x)          # rows near one direction
    plan = tm_.epilogue_plan(B, H, V, "rms", cuda)
    cols = tm_.epilogue_work(plan, B, H, V)["cols"]
    lo, hi = cols[0][1] + 5, cols[-1][1] + 3
    h = x[0] * torch.rsqrt(x[0].square().mean() + 1e-6) * nw
    w[lo] = w[hi] = 0.5 * h / h.norm()
    lg, nxt, bad = tm_.fused_decode_epilogue(*args, None,
                                             torch.zeros(B, device=cuda),
                                             **kw)
    torch.cuda.synchronize()
    assert torch.equal(lg[:, lo], lg[:, hi])
    assert bool((lg[:, lo][:, None] > lg).sum(1).eq(V - 2).all())
    assert nxt.tolist() == [lo] * B and not bad.any()


@pytest.mark.gpu
@pytest.mark.parametrize("B", [8, 16])
def test_epilogue_nonfinite_last_column_flags_row_on_card(cuda, B):
    """A logit that overflows to inf in the last vocab column of one row
    only: that row is bad with token 0, the others pick as the plain
    version does."""
    H, V = 4096, 32000
    args, kw = _epilogue_card(cuda, B, H, V, "rms", seed=5)
    x, nw, _, w = args
    nw.fill_(1.0)
    x[:, 0] = 0.1
    x[B // 3, 0] = 5.0                 # its normalised value ~5
    w[V - 1].zero_()
    w[V - 1, 0] = 3e38                 # 1.5e39 there, finite elsewhere
    pz = torch.zeros(B, device=cuda)
    lg, nxt, bad = tm_.fused_decode_epilogue(*args, None, pz, **kw)
    rl, rn, rb = _plain_epilogue(args, pz, kw)
    torch.cuda.synchronize()
    assert bad.tolist() == [r == B // 3 for r in range(B)]
    assert torch.equal(bad, rb) and int(nxt[B // 3]) == 0
    assert torch.equal(nxt, rn)
    assert torch.isinf(lg[B // 3, V - 1])


# LLaMA-7B TP=2 (one rank's MLP slices) and the unsharded egress: fp32,
# another summation order, held to 2e-5 of the plain version's largest
# value (chip_smoke's TOL)
def _llama7b_partial(dev, B, inter=5504, H=4096, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed + B)

    def rn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=dev) * std

    return (rn(B, H), 1.0 + rn(H, std=0.1), None, rn(inter, H, std=0.02),
            None, rn(H, inter, std=0.02 / 8), rn(inter, H, std=0.02))


@pytest.mark.gpu
@pytest.mark.parametrize("B", [8, 5, 1])
def test_partial_llama7b_matches_plain_on_card(cuda, B):
    """Row 6 at LLaMA-7B TP=2's shapes (y1 [B, 4096], gate/up [5504,
    4096], down [4096, 5504], RMSNorm): one launch by the library's plan
    (the plain rule's at its resident CTAs), within 2e-5 of the plain
    version's largest value, the same bits on a second call."""
    args = _llama7b_partial(cuda, B)
    kw = dict(arch="llama", norm="rms", eps=1e-6)
    plan = tm_.egress_plan(B, 4096, 0, 5504, cuda)
    assert plan == tm_.egress_plan_for(B, 4096, 0, 5504, plan["most"])
    before = tm_.fused_decode_mlp_partial.launches
    out = tm_.fused_decode_mlp_partial(*args, **kw)
    ref = tm_.fused_decode_mlp_partial_plain(*args, **kw)
    torch.cuda.synchronize()
    assert tm_.fused_decode_mlp_partial.launches == before + 1
    assert float((out - ref).abs().max()) <= 2e-5 * float(ref.abs().max())
    assert torch.equal(out, tm_.fused_decode_mlp_partial(*args, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("B", [8, 5, 1])
def test_mlp_llama7b_matches_plain_on_card(cuda, B):
    """Row 5 (the unsharded SwiGLU egress) at LLaMA-7B's shapes: one
    launch by the library's plan (the plain rule's at its resident CTAs),
    within 2e-5 of the plain version's largest value, the same bits on a
    second call."""
    g = torch.Generator(device=cuda).manual_seed(8 + B)
    H, I = 4096, 11008
    plan = tm_.egress_plan(B, H, H, I, cuda)
    assert plan == tm_.egress_plan_for(B, H, H, I, plan["most"])

    def rn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=cuda) * std

    args = (rn(B, H), rn(B, H), rn(H, H, std=0.02), None,
            1.0 + rn(H, std=0.1), None, rn(I, H, std=0.02), None,
            rn(H, I, std=0.02 / 8), None, rn(I, H, std=0.02))
    kw = dict(arch="llama", norm="rms", eps=1e-6)
    out = tm_.fused_decode_mlp(*args, **kw)
    ref = tm_.fused_decode_mlp_plain(*args, **kw)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= 2e-5 * float(ref.abs().max())
    assert torch.equal(out, tm_.fused_decode_mlp(*args, **kw))
