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


POISON = np.asarray([0.0, 0.0, np.nan, 0.0, 0.0], np.float32)


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
    # rows sharing a (page, slot) leave an unspecified one of their values
    # on the card; compare the entries exactly one row writes
    key = [(a["bt"][b, min(p // 4, 2)], p % 4) for b, p in enumerate(a["pos"])]
    for page, slot in {k for k in key if key.count(k) > 1}:
        kp[:, page, slot] = rk[:, page, slot]
        vp[:, page, slot] = rv[:, page, slot]
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
