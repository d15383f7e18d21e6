"""The port's ragged paged attention against the JAX package's.

On the CPU, the port's wrapper runs its plain PyTorch version; it is
held against ``paddle_tpu.ops.pallas.paged_attention`` run as the JAX
tests run it on the CPU (Pallas interpret mode), on the same numpy
inputs: rtol = atol = 1e-5 (fp32, another summation order). On a card
(``-m gpu``) the CUDA kernel is held against the plain version.

The kernel's two routes (``route``) and its plan (``work_plan``: tiles
of query rows, kv splits) are plain functions tested here, and two plain
PyTorch models follow the kernel's arithmetic on the CPU: its split-KV
work (64-token chunks, online softmax, splits combined in order) in
fp64, held against the plain version on the workloads held against JAX;
and its tensor-core arithmetic (fp32 values as three bf16 planes, the
products the kernel takes), which the stated limit admits while it
refuses a dropped plane, a missed rescale and a lost split partial. On a
card each route runs at ``chip_smoke.py``'s serving shapes, ragged
q_len, idle slots, GQA and tensor parallelism's head counts.

JAX is imported inside a fixture, so this file also collects on a
machine without JAX (the card's), where only the ``gpu`` tests run:
``python -m pytest --noconftest -m gpu tests/test_torch_*.py``.
"""
import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.cuda import paged_attention as tpa
from paddle_tpu_torch.ops.cuda.paged_attention import (
    paged_decode_attention, ragged_paged_attention,
    ragged_paged_attention_plain)

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
def pga():
    pytest.importorskip("jax")
    from paddle_tpu.ops.pallas import paged_attention
    return paged_attention


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _case(seed, kv_lens, q_lens, hq, hk, d, ps, q_block, extra_pages=3):
    """Pools with shuffled page ids, block tables, packed q (segments at
    q_block edges, a trailing padding q block) and the valid rows."""
    rng = np.random.default_rng(seed)
    B = len(kv_lens)
    npg = [-(-kv // ps) for kv in kv_lens]
    NP = max(npg) + 1
    P = 1 + sum(npg) + extra_pages
    perm = rng.permutation(np.arange(1, P))
    bt = np.zeros((B, NP), np.int32)
    at = 0
    for b in range(B):
        bt[b, :npg[b]] = perm[at:at + npg[b]]
        at += npg[b]
    k = rng.normal(size=(hk, P, ps, d)).astype(np.float32)
    v = rng.normal(size=(hk, P, ps, d)).astype(np.float32)
    segs = [-(-ql // q_block) * q_block for ql in q_lens]
    starts = np.cumsum([0] + segs[:-1])
    T = sum(segs) + q_block
    q = rng.normal(size=(T, hq, d)).astype(np.float32)
    rows = np.concatenate([np.arange(s, s + n)
                           for s, n in zip(starts, q_lens)])
    return (q, k, v, bt, np.asarray(kv_lens, np.int32),
            np.asarray(q_lens, np.int32), rows)


CASES = {
    # name: (kv_lens, q_lens, hq, hk, d, page_size, q_block)
    "mixed_qb2": ([13, 6, 21, 1], [5, 1, 9, 1], 4, 4, 16, 8, 2),
    "mixed_qb8": ([40, 7, 19], [17, 1, 8], 4, 4, 16, 8, 8),
    "zero_qlen_slot": ([10, 9, 12], [2, 0, 3], 2, 2, 16, 8, 2),
    "page_edges": ([8, 16, 17, 31, 32], [8, 1, 1, 15, 2], 2, 2, 16, 8, 4),
    "page16": ([33, 5, 48], [16, 5, 1], 4, 4, 32, 16, 8),
    "gqa_rep2": ([20, 11], [6, 1], 4, 2, 16, 8, 2),
    "gqa_rep4": ([26, 9, 3], [9, 2, 3], 8, 2, 16, 16, 4),
    "gqa_rep3_row_pad": ([15, 22], [3, 7], 6, 2, 16, 8, 2),
}


def _torch_args(q, k, v, bt, kvl, ql, device="cpu"):
    return [torch.tensor(a, device=device) for a in (q, k, v, bt, kvl, ql)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_ragged_matches_jax(pga, name):
    kv_lens, q_lens, hq, hk, d, ps, qb = CASES[name]
    q, k, v, bt, kvl, ql, rows = _case(7, kv_lens, q_lens, hq, hk, d,
                                       ps, qb)
    ref = np.asarray(pga.ragged_paged_attention(
        q, k, v, bt, kvl, ql, q_block=qb, interpret=True))
    out = ragged_paged_attention(*_torch_args(q, k, v, bt, kvl, ql),
                                 q_block=qb).numpy()
    np.testing.assert_allclose(out[rows], ref[rows], **TOL)
    # rows past the live segments are written 0
    assert not out[len(q) - qb:].any()


@pytest.mark.parametrize("hq,hk,ps", [(4, 4, 8), (8, 2, 16)])
def test_decode_matches_jax(pga, hq, hk, ps):
    kv_lens = [1, 7, 8, 9, 25]
    q, k, v, bt, kvl, _, _ = _case(3, kv_lens, [1] * 5, hq, hk, 16, ps, 1)
    q = q[:5]
    ref = np.asarray(pga.paged_decode_attention(q, k, v, bt, kvl,
                                                interpret=True))
    tq, tk, tv, tbt, tkvl = (torch.tensor(a) for a in (q, k, v, bt, kvl))
    out = paged_decode_attention(tq, tk, tv, tbt, tkvl).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_scale_and_pages_per_block_parity(pga):
    q, k, v, bt, kvl, ql, rows = _case(11, [18, 5], [4, 1], 4, 2, 16, 8, 2)
    ref = np.asarray(pga.ragged_paged_attention(
        q, k, v, bt, kvl, ql, q_block=2, pages_per_block=1, scale=0.3,
        interpret=True))
    out = ragged_paged_attention(*_torch_args(q, k, v, bt, kvl, ql),
                                 q_block=2, pages_per_block=1,
                                 scale=0.3).numpy()
    np.testing.assert_allclose(out[rows], ref[rows], **TOL)


def _small():
    q, k, v, bt, kvl, ql, _ = _case(1, [9, 4], [3, 1], 4, 2, 16, 8, 2)
    return _torch_args(q, k, v, bt, kvl, ql)


@pytest.mark.parametrize("mutate,exc,match", [
    (lambda a: a.__setitem__(0, a[0].double()), TypeError, "float32"),
    (lambda a: a.__setitem__(1, a[1].half()), TypeError, "float32"),
    (lambda a: a.__setitem__(3, a[3].float()), TypeError, "integer"),
    (lambda a: a.__setitem__(0, a[0][:, :3]), ValueError, "multiple"),
    (lambda a: a.__setitem__(0, a[0][..., :8]), ValueError, "head_dim"),
    (lambda a: a.__setitem__(2, a[2][:, :-1]), ValueError, "pool shapes"),
    (lambda a: a.__setitem__(4, a[4][:1]), ValueError, "kv_lens"),
    (lambda a: a.__setitem__(3, a[3][0]), ValueError, "block_tables"),
    (lambda a: a.__setitem__(0, a[0][0]), ValueError, "q must be"),
    (lambda a: a.__setitem__(1, a[1].to("meta")), ValueError, "devices"),
])
def test_wrapper_validation(mutate, exc, match):
    args = _small()
    mutate(args)
    with pytest.raises(exc, match=match):
        ragged_paged_attention(*args, q_block=2)


def test_wrapper_rejects_tpu_only_arguments():
    args = _small()
    # scale pools are ported (int8 pools, tests/test_torch_quantization.py)
    # and belong with int8 pools only: fp32 pools with scales are refused
    scales = torch.ones(tuple(args[1].shape[:3]))
    for kw in ({"interpret": True}, {"item_budget": 4},
               {"k_scales": scales, "v_scales": scales}):
        with pytest.raises(TypeError):
            ragged_paged_attention(*args, q_block=2, **kw)
    with pytest.raises(ValueError, match="q_block"):
        ragged_paged_attention(*args, q_block=0)


def test_wrapper_counts_only_kernel_launches():
    before = ragged_paged_attention.launches
    ragged_paged_attention(*_small(), q_block=2)   # CPU: plain version
    assert ragged_paged_attention.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_on_card(cuda, name):
    kv_lens, q_lens, hq, hk, d, ps, qb = CASES[name]
    q, k, v, bt, kvl, ql, rows = _case(7, kv_lens, q_lens, hq, hk, d,
                                       ps, qb)
    args = _torch_args(q, k, v, bt, kvl, ql, device=cuda)
    before = ragged_paged_attention.launches
    out = ragged_paged_attention(*args, q_block=qb)
    torch.cuda.synchronize()
    assert ragged_paged_attention.launches == before + 1
    ref = ragged_paged_attention_plain(*args, q_block=qb)
    # fp32, another summation order: the same 1e-5 as against JAX; rows
    # of segment padding are compared too (both write the same rows)
    torch.testing.assert_close(out, ref, **TOL)


# ------------------------------------------------------ routes, plan --
@pytest.mark.parametrize("q_block,rep,want", [
    (8, 1, "mixed"), (2, 4, "mixed"), (1, 1, "decode"), (1, 2, "decode"),
    (1, 4, "decode"), (1, 3, "mixed"), (1, 8, "mixed"), (64, 1, "mixed")])
def test_route_rule(q_block, rep, want):
    assert tpa.route(q_block, rep) == want


# longer kv ranges than CASES: several 64-token chunks and kv splits
LONG = {
    # name: (kv_lens, q_lens, hq, hk, d, page_size, q_block)
    "long_mixed": ([300, 1, 140, 77], [64, 0, 1, 9], 4, 2, 16, 16, 8),
    "long_decode": ([300, 1, 140, 77], [1, 1, 1, 1], 4, 2, 16, 16, 1),
    "long_decode_ragged": ([300, 140], [3, 2], 2, 2, 16, 16, 1),
}
WORKLOADS = {**CASES, **LONG}


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_work_plan_covers_every_row_once(name):
    """Every query row of every live segment is in exactly one unit;
    each unit's splits tile [0, its kv need) in order; a mixed tile has
    at most TILE_ROWS rows, and no unit more splits than the scratch
    holds."""
    kv_lens, q_lens, hq, hk, d, ps, qb = WORKLOADS[name]
    q, _, _, bt, _, _, rows = _case(7, kv_lens, q_lens, hq, hk, d, ps, qb)
    rep = hq // hk
    which = tpa.route(qb, rep)
    units = tpa.work_plan(kv_lens, q_lens, qb, rep, len(q), bt.shape[1], ps)
    seen = [r for u in units for r in u["rows"]]
    assert len(seen) == len(set(seen))
    live = {(int(t), h) for t in rows for h in range(rep)}
    assert live <= set(seen)
    for u in units:
        assert len(u["rows"]) <= (rep if which == "decode"
                                  else tpa.TILE_ROWS)
        assert 1 <= u["splits"] <= tpa.max_splits(which, bt.shape[1], ps)
        need = max(0, min(kv_lens[u["b"]], max(u["pos"]) + 1))
        assert u["kv"][0][0] == 0 and max(hi for _, hi in u["kv"]) == need
        for (_, hi), (lo2, _) in zip(u["kv"], u["kv"][1:]):
            assert lo2 == min(hi, need) or lo2 >= need
    if name.startswith("long"):
        assert max(u["splits"] for u in units) > 1


def _pages(x, bt, b, kv, hk, d, ps, scales=None):
    """Sequence b's first kv K or V vectors [Hk, kv, D] in fp64 (int8
    ones times their slots' scales)."""
    npg = -(-kv // ps)
    pages = bt[b, :npg].long()
    out = x[:, pages].reshape(hk, npg * ps, d)[:, :kv].double()
    if scales is not None:
        out = out * scales[:, pages].reshape(hk, npg * ps)[:, :kv, None]
    return out


def _planes(x, n):
    """x (fp32 values) as n bf16 planes, largest first (hi + mid + lo)."""
    out, r = [], x.float()
    for _ in range(n):
        p = r.to(torch.bfloat16).float()
        out.append(p.double())
        r = r - p
    return out


def _dot(a, b, terms, split_b=True):
    """a @ b.T as the tensor cores take it: fp32 a and (``split_b``) b
    as three bf16 planes each and the products of planes (i, j) in
    ``terms``; an int8 b (``split_b`` False) is exact."""
    pa = _planes(a, 3)
    pb = _planes(b, 3) if split_b else [b.double()]
    return sum(pa[i] @ pb[j].T for i, j in terms)


ORDER2 = [(i, j) for i in range(3) for j in range(3) if i + j <= 2]


def _model(q, k, v, bt, kvl, ql, q_block, ks=None, vs=None, tc=False,
           terms=None, rescale=True, drop_split=False):
    """The kernel's work as a plain PyTorch model: :func:`work_plan`'s
    units, each split in 64-token chunks with an online softmax, the
    splits combined in order. fp64 sums; with ``tc`` the products are
    the tensor cores' (:func:`_dot`: q and P as bf16 planes, fp32 K and
    V too, ``terms`` the products kept). ``rescale=False`` skips the
    online softmax's rescale of the running sums, ``drop_split`` loses
    a unit's last split partial."""
    t, hq, d = q.shape
    hk, _, ps, _ = k.shape
    rep = hq // hk
    q8 = ks is not None
    terms = terms or (ORDER2 if not q8 else [(0, 0), (1, 0), (2, 0)])
    scale = 1.0 / math.sqrt(d)
    out = torch.zeros(t, hq, d, dtype=torch.float64)
    units = tpa.work_plan(kvl.tolist(), ql.tolist(), q_block, rep, t,
                          bt.shape[1], ps)
    for u in units:
        b, kv = u["b"], int(kvl[u["b"]])
        pos = torch.tensor(u["pos"])
        for h in range(hk):
            kk = _pages(k, bt, b, kv, hk, d, ps)[h]
            vv = _pages(v, bt, b, kv, hk, d, ps)[h]
            if q8:
                npg = -(-kv // ps)
                pg = bt[b, :npg].long()
                ksc = ks[h, pg].reshape(-1)[:kv].double()
                vsc = vs[h, pg].reshape(-1)[:kv].double()
            qr = torch.stack([q[tok, h * rep + r] for tok, r in u["rows"]])
            qr = (qr * scale).float()
            parts = []
            for lo, hi in u["kv"]:
                m = torch.full((len(u["rows"]),), -math.inf,
                               dtype=torch.float64)
                l = torch.zeros(len(u["rows"]), dtype=torch.float64)
                acc = torch.zeros(len(u["rows"]), d, dtype=torch.float64)
                for c0 in range(lo, hi, tpa.CHUNK):
                    c1 = min(c0 + tpa.CHUNK, hi)
                    kc, vc = kk[c0:c1], vv[c0:c1]
                    if tc:
                        s = _dot(qr, kc.float(), terms, split_b=not q8)
                    else:
                        s = qr.double() @ kc.T
                    if q8:
                        s = s * ksc[c0:c1]
                    allow = torch.arange(c0, c1)[None, :] <= pos[:, None]
                    s = s.masked_fill(~allow, -math.inf)
                    mn = torch.maximum(m, s.max(1).values)
                    fin = mn > -math.inf
                    alpha = torch.where(fin, torch.exp(m - mn),
                                        torch.ones_like(m))
                    p = torch.where(fin[:, None], torch.exp(s - mn[:, None]),
                                    torch.zeros_like(s))
                    if rescale:
                        l, acc = l * alpha, acc * alpha[:, None]
                    l = l + p.sum(1)
                    pw = p * vsc[c0:c1] if q8 else p
                    if tc:
                        acc = acc + sum(pa @ pb for pa, pb in
                                        _pv_terms(pw, vc, terms, q8))
                    else:
                        acc = acc + pw @ vc
                    m = mn
                parts.append((m, l, acc))
            if drop_split and len(parts) > 1:
                parts = parts[:-1]
            mm = torch.stack([p[0] for p in parts]).max(0).values
            L = torch.zeros_like(mm)
            A = torch.zeros(len(u["rows"]), d, dtype=torch.float64)
            for m, l, acc in parts:
                w = torch.where(m > -math.inf, torch.exp(m - mm),
                                torch.zeros_like(m))
                L, A = L + l * w, A + acc * w[:, None]
            o = torch.where(L[:, None] > 0, A / L[:, None].clamp_min(1e-300),
                            torch.zeros_like(A))
            for i, (tok, r) in enumerate(u["rows"]):
                out[tok, h * rep + r] = o[i]
    return out.float()


def _pv_terms(p, vc, terms, q8):
    """The P.V products the tensor cores take: P (fp32) as bf16 planes,
    fp32 V as planes too (int8 V exact), the plane pairs in ``terms``."""
    pp = _planes(p, 3)
    pv = [vc.double()] if q8 else _planes(vc, 3)
    return [(pp[i], pv[j]) for i, j in terms]


def _workload(name, int8=False):
    kv_lens, q_lens, hq, hk, d, ps, qb = WORKLOADS[name]
    q, k, v, bt, kvl, ql, rows = _case(7, kv_lens, q_lens, hq, hk, d, ps,
                                       qb)
    args = _torch_args(q, k, v, bt, kvl, ql)
    sc = {}
    if int8:
        from paddle_tpu_torch.quantization import kv_quantize
        args[1], ks = kv_quantize(args[1])
        args[2], vs = kv_quantize(args[2])
        sc = dict(k_scales=ks, v_scales=vs)
    return args, sc, qb


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_split_kv_model_matches_plain(name, int8):
    """The kernel's split-KV work (plan, chunks, online softmax, splits
    combined in order), in fp64, is the plain version's function: every
    row, segment padding and the zero rows past the live segments
    included, within 1e-5."""
    args, sc, qb = _workload(name, int8)
    ref = ragged_paged_attention_plain(*args, q_block=qb, **sc)
    got = _model(*args, qb, ks=sc.get("k_scales"), vs=sc.get("v_scales"))
    torch.testing.assert_close(got, ref, **TOL)


def _excess(got, ref):
    """Largest ratio of |got - ref| to the stated limit, 1e-5 + 1e-5
    |ref| (the card's test's rtol = atol = 1e-5)."""
    return float(((got - ref).abs() / (1e-5 + 1e-5 * ref.abs())).max())


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("name", ["long_mixed", "long_decode", "page16",
                                  "gqa_rep4"])
def test_tensor_core_arithmetic_within_limit(name, int8):
    """The tensor cores' arithmetic (fp32 values as three bf16 planes;
    fp32 pools: the six products of order <= 2, int8 pools: q's and P's
    three planes against exact K and V) is within the limit the card's
    tests hold the kernel to; dropping q's mid plane, skipping the
    online softmax's rescale or losing a split partial is not."""
    args, sc, qb = _workload(name, int8)
    kw = dict(ks=sc.get("k_scales"), vs=sc.get("v_scales"), tc=True)
    ref = ragged_paged_attention_plain(*args, q_block=qb, **sc)
    assert _excess(_model(*args, qb, **kw), ref) < 0.5
    full = ORDER2 if not int8 else [(0, 0), (1, 0), (2, 0)]
    no_mid = [(i, j) for i, j in full if i != 1]
    assert _excess(_model(*args, qb, terms=no_mid, **kw), ref) > 10
    if name == "long_mixed":   # splits of several chunks
        assert _excess(_model(*args, qb, rescale=False, **kw), ref) > 10
    if name.startswith("long"):
        assert _excess(_model(*args, qb, drop_split=True, **kw), ref) > 10


# ------------------------------------------------------- card routes --
CARD = {
    # name: (kv_lens, q_lens, hq, hk, d, page_size, q_block)
    "ragged_qlen_mixed": ([37, 130, 9, 260], [5, 64, 9, 3], 12, 12, 64, 16,
                          8),
    "idle_slots_mixed": ([1, 300, 1, 44], [0, 17, 0, 1], 12, 12, 64, 16, 8),
    "idle_slots_decode": ([1, 300, 1, 44], [0, 1, 0, 1], 12, 12, 64, 16, 1),
    "gqa_32q_8kv_mixed": ([300, 70], [64, 1], 32, 8, 128, 16, 8),
    "gqa_32q_8kv_decode": ([300, 70, 900], [1, 1, 1], 32, 8, 128, 16, 1),
    "gqa_rep2_decode": ([130, 7], [1, 1], 8, 4, 32, 16, 1),
    "gqa_rep8_qb1": ([130, 7], [1, 1], 16, 2, 64, 16, 1),
    "tp_gpt_6_heads_mixed": ([500, 64, 1000], [1, 64, 1], 6, 6, 64, 16, 8),
    "tp_gpt_6_heads_decode": ([500, 64, 1000], [1, 1, 1], 6, 6, 64, 16, 1),
    "tp_llama_16_heads_mixed": ([500, 64, 17], [1, 64, 1], 16, 16, 128, 16,
                                8),
    "tp_llama_16_heads_decode": ([500, 64, 17], [1, 1, 1], 16, 16, 128, 16,
                                 1),
    "long_decode_splits": ([2000, 3], [1, 1], 4, 4, 128, 16, 1),
    "prefill_128_rows": ([400], [128], 8, 4, 64, 16, 16),
}


def _card_args(name, int8, device):
    kv_lens, q_lens, hq, hk, d, ps, qb = CARD[name]
    q, k, v, bt, kvl, ql, _ = _case(13, kv_lens, q_lens, hq, hk, d, ps, qb)
    args = _torch_args(q, k, v, bt, kvl, ql, device=device)
    sc = {}
    if int8:
        from paddle_tpu_torch.quantization import kv_quantize
        args[1], ks = kv_quantize(args[1])
        args[2], vs = kv_quantize(args[2])
        sc = dict(k_scales=ks, v_scales=vs)
    return args, sc, qb, tpa.route(qb, hq // hk)


def _launch_on_route(args, sc, qb, which):
    rpa = ragged_paged_attention
    before = (rpa.launches, rpa.mixed_launches, rpa.decode_launches)
    out = rpa(*args, q_block=qb, **sc)
    torch.cuda.synchronize()
    assert (rpa.launches - before[0], rpa.mixed_launches - before[1],
            rpa.decode_launches - before[2]) == \
        ((1, 1, 0) if which == "mixed" else (1, 0, 1))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("name", sorted(CARD))
def test_route_matches_plain_on_card(cuda, name, int8):
    """Each route against the plain version, every row (segment padding
    and the zero rows past the live segments too): ragged q_len, idle
    slots, GQA (32 q heads on 8 kv heads, groups of 2 and 8 at q_block
    1), tensor parallelism's head counts (GPT-124M 6, LLaMA-7B 16 a
    rank), a 2000-token decode over many splits, a 128-row prefill."""
    args, sc, qb, which = _card_args(name, int8, cuda)
    out = _launch_on_route(args, sc, qb, which)
    ref = ragged_paged_attention_plain(*args, q_block=qb, **sc)
    torch.testing.assert_close(out, ref, **TOL)
    # the same inputs again: the split combine's fixed order
    assert torch.equal(ragged_paged_attention(*args, q_block=qb, **sc), out)


@pytest.mark.gpu
def test_routes_at_chip_smoke_shapes_on_card(cuda):
    """The serving shapes of ``chip_smoke.py`` (GPT-124M and LLaMA-7B,
    fp32 and int8 pools, mixed and decode steps, GQA), each on its route
    and within chip_smoke's TOL of the plain version."""
    import pathlib
    import sys
    root = str(pathlib.Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    gen = torch.Generator().manual_seed(0)
    for (name, kvl, ql, hq, hk, d, ps, qb, pages, width,
         T) in chip_smoke.attention_cases(0):
        args, sc = chip_smoke._attn_case(gen, kvl, ql, hq, hk, d, ps, qb,
                                         pages, width, T,
                                         int8="int8" in name)
        out = _launch_on_route(args, sc, qb, tpa.route(qb, hq // hk))
        ref = ragged_paged_attention_plain(*args, q_block=qb, **sc)
        err = float((out - ref).abs().max())
        assert err <= chip_smoke.TOL, (name, err)
        del args, sc, out, ref
