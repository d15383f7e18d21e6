"""The port's tensor-parallel (TP=2) serving against the JAX package.

Two ranks, spawned, run the port on the CPU over a gloo process group
(rendezvous through a file under the test's temporary directory, every
wait bounded). Each rank builds the same tiny models from the JAX
package's weights: the GPT of conftest's ``serving_gpt`` (vocab 96,
hidden 32, 2 layers, 4 heads) and a one-layer LLaMA with GQA (4 heads on
2 kv heads, so each rank holds one kv head), and in one pass:

* takes its ``tp_shard_params`` slices, which must equal the JAX
  ``tp_shard_params`` shards on a 2-device CPU mesh exactly (in the
  JAX layout), with the same ``meta``;
* raises on head counts the cut cannot serve with the JAX package's
  ``ValueError`` messages; refuses the replicated-KV regime and
  speculative decoding with a mesh;
* serves each family's workload through the TP engine (``mesh=`` a 1-D
  ``DeviceMesh``), megakernel off and on, fp32 and int8 pools: token
  streams, finish reasons and every ``stats`` counter must equal the JAX
  single-device engine's (the reference's own TP contract) on both
  ranks; int8 pool bytes must equal the single-device engine's for the
  rank's heads; every forward runs two all-reduces a layer.

The four JAX single-device engines compile in interpret mode (5-15 s
each) while the ranks serve: the GPT ones in this process, the LLaMA
ones in a third spawned process. Row 6's plain version is
held against the JAX ``fused_decode_mlp_partial`` in interpret mode on
one shard's slices; on a card (``-m gpu``) the kernel is held against its
plain version.
"""
import multiprocessing as mp
import pickle
import sys
import time
from datetime import timedelta
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.cuda import fused_decode_mlp as tfm

TOL = dict(rtol=1e-5, atol=1e-5)
WAIT_S = 150           # every rendezvous, collective and join
GPT_CFG = dict(vocab_size=96, hidden_size=32, num_layers=2, num_heads=4,
               max_seq_len=64)
LLAMA_CFG = dict(vocab_size=96, hidden_size=32, num_layers=1, num_heads=4,
                 num_kv_heads=2, max_seq_len=64)
GEO = {"gpt": dict(max_slots=2, page_size=4, max_seq_len=32,
                   decode_window=4, prefill_chunk=8, q_block=2,
                   pages_per_block=1),
       "llama": dict(max_slots=2, page_size=8, max_seq_len=32,
                     decode_window=3, prefill_chunk=6, q_block=2,
                     pages_per_block=1)}
WORK = {"gpt": (0, (5, 9, 3, 12), (6, 4, 7, 5)),
        "llama": (3, (7, 4, 11), (5, 6, 4))}
LEGS = [(fam, mk, kvq) for fam in ("gpt", "llama") for kvq in (False, True)
        for mk in (False, True)]
# head counts the cut cannot serve at tp=2, and the replicated-KV regime
BAD = {"gpt_heads": ("gpt", dict(GPT_CFG, hidden_size=24, num_heads=3)),
       "gpt_inter": ("gpt", dict(GPT_CFG, intermediate_size=33)),
       "llama_kv_heads": ("llama", dict(LLAMA_CFG, hidden_size=48,
                                        num_heads=6, num_kv_heads=3))}
BANNED = ("jax", "jaxlib", "paddle_tpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests share the machine's cores with
    other test workers, and PyTorch's thread pool, spinning on small ops
    against them, slowed these CPU runs by two orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts(family):
    seed, sizes, new = WORK[family]
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 96, (n,)).astype(np.int32) for n in sizes], new


def _serve(eng, family, on_step=None):
    """Serve ``family``'s workload on ``eng``; ``on_step(eng)`` runs
    around each step and returns what it records."""
    prompts, new = _prompts(family)
    for p, n in zip(prompts, new):
        eng.add_request(p, n)
    done, steps = {}, []
    while eng.has_work:
        before = on_step(eng) if on_step else None
        done.update({c.request_id: c for c in eng.step()})
        if on_step:
            steps.append((before, on_step(eng)))
    st = eng.stats
    eng._cache.check()
    return {"out": {rid: (c.tokens.tolist(), c.finish_reason)
                    for rid, c in done.items()},
            "stats": st, "steps": steps,
            "conserved": (st["pages_in_use"] == 0 and st["pages_in_use"]
                          + st["pages_free"] + st["cached_pages"]
                          == eng.total_pages - 1)}


def _port_model(family, cfg, named=None):
    from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                         LlamaConfig, LlamaForCausalLM,
                                         load_gpt_from_jax,
                                         load_llama_from_jax)
    if family == "gpt":
        m = GPTForCausalLM(GPTConfig(**cfg), device="cpu")
        return m if named is None else load_gpt_from_jax(m, named)
    m = LlamaForCausalLM(LlamaConfig(**cfg), device="cpu")
    return m if named is None else load_llama_from_jax(m, named)


def _error(fn):
    try:
        fn()
    except Exception as e:     # noqa: BLE001 - recorded for the parent
        return type(e).__name__, str(e)
    return None


def _rank_main(rank, tmp):
    """One TP rank: imports the port only; writes its results to
    ``tmp/rank{rank}.pkl``."""
    torch.set_num_threads(1)
    from torch.distributed.device_mesh import init_device_mesh

    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.models import generation as tgen

    tmp = Path(tmp)
    pdist.init_parallel_env(backend="gloo",
                            init_method=f"file://{tmp / 'rendezvous'}",
                            world_size=2, rank=rank,
                            timeout=timedelta(seconds=WAIT_S))
    try:
        named = pickle.loads((tmp / "weights.pkl").read_bytes())
        mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("tp",))
        world = pdist.get_group()
        res = {"slices": {}, "errors": {}, "legs": {}, "refusals": {}}
        models = {}
        for fam, cfg in (("gpt", GPT_CFG), ("llama", LLAMA_CFG)):
            models[fam] = _port_model(fam, cfg, named[fam])
            tpp = tgen.tp_shard_params(models[fam], world)
            res["slices"][fam] = dict(names=list(tpp.names), meta=tpp.meta,
                                      vals=[v.numpy() for v in tpp.vals])
        for name, (fam, cfg) in BAD.items():
            res["errors"][name] = _error(lambda: tgen.tp_shard_params(
                _port_model(fam, cfg), mesh))

        def counts(eng):
            return (pdist.all_reduce.calls, eng.stats["mixed_steps"],
                    eng.stats["decode_dispatches"],
                    eng._geometry() in eng._decoded_geometries())

        for fam, mk, kvq in LEGS:
            eng = ContinuousBatchingEngine(
                models[fam], mesh=mesh, megakernel=mk, kv_quant=kvq,
                device="cpu", **GEO[fam])
            leg = _serve(eng, fam, counts)
            leg["tp"] = (eng.tp, eng.tp_axis)
            if kvq:
                L = models[fam].cfg.num_layers
                leg["pools"] = [p.numpy() for p in eng._caches]
                assert len(leg["pools"]) == 4 * L
            res["legs"][(fam, mk, kvq)] = leg
        # the model a rank cut still serves whole on one device
        res["whole"] = _serve(ContinuousBatchingEngine(
            models["gpt"], device="cpu", **GEO["gpt"]), "gpt")
        geo = dict(GEO["gpt"], device="cpu")
        res["refusals"]["spec_decode"] = _error(
            lambda: ContinuousBatchingEngine(models["gpt"], mesh=mesh,
                                             spec_decode=True, **geo))
        res["refusals"]["kv_heads_below_tp"] = _error(
            lambda: ContinuousBatchingEngine(
                _port_model("llama", dict(LLAMA_CFG, num_kv_heads=1)),
                mesh=mesh, **dict(GEO["llama"], device="cpu")))
        res["modules"] = sorted(m for m in sys.modules
                                if m.split(".")[0] in BANNED)
        (tmp / f"rank{rank}.pkl").write_bytes(pickle.dumps(res))
    finally:
        pdist.destroy_process_group()


def _jax_model(family):
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt import GPTConfig, GPTForCausalLM
    from paddle_tpu.models.llama import LlamaConfig, LlamaForCausalLM
    paddle.seed(0)
    if family == "gpt":
        m = GPTForCausalLM(GPTConfig(**GPT_CFG, dropout=0.0))
    else:
        m = LlamaForCausalLM(LlamaConfig(**LLAMA_CFG))
    m.eval()
    return m


def _named(model):
    return {k: np.asarray(v.numpy()) for k, v in model.state_dict().items()}


def _jax_ref(model, family, kvq):
    """The JAX single-device engine on ``family``'s workload over fp32
    or (``kvq``) int8 pools; each (model, geometry) is fresh, so each
    engine runs its decode bootstrap as the ranks' do."""
    from paddle_tpu.inference import ContinuousBatchingEngine as JEngine
    eng = JEngine(model, kv_quant=kvq, **GEO[family])
    out = _serve(eng, family)
    if kvq:
        out["pools"] = [np.asarray(c.numpy()) for c in eng._caches]
    return out


def _llama_refs_main(tmp):
    """The LLaMA references of :func:`_jax_ref`, fp32 and int8 pools, in
    a process of their own (spawned, so this process's JAX CPU backend
    and its 8 host devices come anew from the environment the test
    process set) while the test process compiles the GPT ones; writes
    them to ``tmp/jax_llama.pkl``."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    model = _jax_model("llama")
    refs = {kvq: _jax_ref(model, "llama", kvq) for kvq in (False, True)}
    (Path(tmp) / "jax_llama.pkl").write_bytes(pickle.dumps(refs))


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("tp_serving")
    models = {fam: _jax_model(fam) for fam in ("gpt", "llama")}
    (tmp / "weights.pkl").write_bytes(pickle.dumps(
        {fam: _named(m) for fam, m in models.items()}))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, str(tmp)))
             for r in range(2)]
    procs.append(ctx.Process(target=_llama_refs_main, args=(str(tmp),)))
    for p in procs:
        p.start()
    try:
        jax_refs = {("gpt", kvq): _jax_ref(models["gpt"], "gpt", kvq)
                    for kvq in (False, True)}
    finally:
        deadline = time.monotonic() + WAIT_S
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    codes = [p.exitcode for p in procs]
    assert codes == [0, 0, 0], f"ranks and LLaMA references exited {codes}"
    ranks = [pickle.loads((tmp / f"rank{r}.pkl").read_bytes())
             for r in range(2)]
    jax_refs.update({("llama", kvq): ref for kvq, ref in pickle.loads(
        (tmp / "jax_llama.pkl").read_bytes()).items()})
    return {"jax": jax_refs, "ranks": ranks, "models": models}


# ------------------------------------------------------------ layout --
def _as_jax_layout(name, v):
    """A port slice (``[out, in]``, cut dims factored) in the JAX
    package's layout (``[in, out]``)."""
    suffix = name.split(".", 1)[-1]
    if suffix == "qkv.w":                       # [3, nh, hd, h]
        return v.transpose(3, 0, 1, 2)
    if suffix in ("proj.w", "o.w"):             # [h, nh, hd]
        return v.transpose(1, 2, 0)
    if suffix in ("q.w", "k.w", "v.w"):         # [nh, hd, h]
        return v.transpose(2, 0, 1)
    if suffix in ("fc1.w", "fc2.w", "gate.w", "up.w", "down.w") \
            or name == "lm_head":
        return v.T
    return v


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_shard_params_match_jax(tp_runs, family):
    import jax
    from jax.sharding import Mesh

    from paddle_tpu.models.generation import tp_shard_params
    jmodel = tp_runs["models"][family]
    jmesh = Mesh(np.asarray(jax.devices()[:2]), ("tp",))
    jt = tp_shard_params(jmodel, jmesh, "tp")
    for r, rank in enumerate(tp_runs["ranks"]):
        got = rank["slices"][family]
        assert got["names"] == list(jt.names)
        assert got["meta"] == jt.meta
        dev = jmesh.devices[r]
        for name, v, jv in zip(jt.names, got["vals"], jt.vals):
            (shard,) = [s for s in jv.addressable_shards if s.device == dev]
            np.testing.assert_array_equal(_as_jax_layout(name, v),
                                          np.asarray(shard.data),
                                          err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("case", sorted(BAD))
def test_bad_head_counts_raise_as_jax(tp_runs, case):
    import jax
    from jax.sharding import Mesh

    from paddle_tpu.models.generation import tp_shard_params
    from paddle_tpu.models.gpt import GPTConfig
    from paddle_tpu.models.llama import LlamaConfig
    family, cfg = BAD[case]
    # the JAX function reads the config, then raises: a stand-in holding
    # the config saves drawing the weights
    jm = SimpleNamespace(cfg=GPTConfig(**cfg) if family == "gpt"
                         else LlamaConfig(**cfg))
    with pytest.raises(ValueError) as err:
        tp_shard_params(jm, Mesh(np.asarray(jax.devices()[:2]), ("tp",)),
                        "tp")
    for rank in tp_runs["ranks"]:
        assert rank["errors"][case] == ("ValueError", str(err.value))


# ------------------------------------------------------------ engine --
@pytest.mark.parametrize("leg", LEGS, ids=lambda leg: "{}-{}-{}".format(
    leg[0], "mk" if leg[1] else "unfused", "int8" if leg[2] else "fp32"))
def test_tp_engine_matches_jax_single_device(tp_runs, leg):
    family, _mk, kvq = leg
    ref = tp_runs["jax"][(family, kvq)]
    for rank in tp_runs["ranks"]:
        got = rank["legs"][leg]
        assert got["tp"] == (2, "tp")
        assert got["out"] == ref["out"]
        assert list(got["stats"].items()) == list(ref["stats"].items())
        assert got["conserved"] and ref["conserved"]
    assert ref["stats"]["decode_dispatches"] > ref["stats"]["mixed_steps"]


def test_cut_model_still_serves_whole(tp_runs):
    """``tp_shard_params`` builds the rank-local model beside the model it
    cuts: after every TP leg, the GPT each rank cut serves on one device
    exactly as the JAX single-device engine does."""
    ref = tp_runs["jax"][("gpt", False)]
    for rank in tp_runs["ranks"]:
        got = rank["whole"]
        assert got["out"] == ref["out"]
        assert list(got["stats"].items()) == list(ref["stats"].items())
        assert got["conserved"]


@pytest.mark.parametrize("leg", [leg for leg in LEGS if leg[2]],
                         ids=lambda leg: "{}-{}".format(
                             leg[0], "mk" if leg[1] else "unfused"))
def test_tp_int8_pools_match_jax_single_device(tp_runs, leg):
    """Each rank's int8 pools (and scale pools) are the single-device
    engine's at the rank's kv heads, outside the null page 0 (the
    padding writes' target, whose content is unspecified)."""
    family = leg[0]
    ref = tp_runs["jax"][(family, True)]["pools"]
    for r, rank in enumerate(tp_runs["ranks"]):
        got = rank["legs"][leg]["pools"]
        for i, (g, j) in enumerate(zip(got, ref)):
            hk = g.shape[0]
            j = j[r * hk:(r + 1) * hk]
            if g.dtype == np.int8:
                np.testing.assert_array_equal(g[:, 1:], j[:, 1:],
                                              err_msg=f"rank {r} pool {i}")
            else:
                np.testing.assert_allclose(g[:, 1:], j[:, 1:], rtol=1e-6,
                                           atol=0)


def test_tp_forward_runs_two_all_reduces_a_layer(tp_runs):
    """Every dispatch of every leg: a mixed step's forward or each step of
    a decode window (one step for a geometry's first decode dispatch)
    runs exactly 2 L all-reduces."""
    for rank in tp_runs["ranks"]:
        for leg, got in rank["legs"].items():
            K = GEO[leg[0]]["decode_window"]
            L = (GPT_CFG if leg[0] == "gpt" else LLAMA_CFG)["num_layers"]
            for (c0, m0, d0, seen), (c1, m1, d1, _) in got["steps"]:
                if m1 > m0:
                    steps = 1
                elif d1 > d0:
                    steps = K if seen else 1
                else:
                    steps = 0
                assert c1 - c0 == 2 * L * steps, (leg, c1 - c0, steps)


def test_tp_refusals(tp_runs):
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    for rank in tp_runs["ranks"]:
        kind, msg = rank["refusals"]["spec_decode"]
        assert kind == "NotImplementedError" and "later slice" in msg
        kind, msg = rank["refusals"]["kv_heads_below_tp"]
        assert kind == "NotImplementedError"
        assert "replicated-KV" in msg and "later slice" in msg
    # this process has no process group: a mesh is refused
    model = _port_model("gpt", GPT_CFG)
    for mesh in (object(), "tp"):
        with pytest.raises(RuntimeError, match="initialized process group"):
            ContinuousBatchingEngine(model, mesh=mesh, device="cpu",
                                     **GEO["gpt"])


def test_tp_ranks_import_no_jax(tp_runs):
    for rank in tp_runs["ranks"]:
        assert rank["modules"] == []


# ------------------------------------------------------------ row 6 --
def _partial_inputs(arch, B, seed=5, H=32, inter=64):
    """One shard's slices in the JAX layout (``[in, out]``): H 32 and a
    rank's 64 of 128 MLP columns."""
    rng = np.random.default_rng(seed)

    def n(*s, std=1.0):
        return (rng.normal(size=s) * std).astype(np.float32)

    d = dict(y1=n(B, H), nw=1.0 + n(H, std=0.1), w1=n(H, inter, std=0.2),
             w2=n(inter, H, std=0.2))
    if arch == "gpt":
        d.update(nb=n(H, std=0.1), b1=n(inter, std=0.1), wu=None)
    else:
        d.update(nb=None, b1=None, wu=n(H, inter, std=0.2))
    return d


def _port_partial(d, arch, device="cpu", plain=False):
    def t(a):
        return None if a is None else torch.tensor(
            np.ascontiguousarray(a), device=device)

    fn = tfm.fused_decode_mlp_partial_plain if plain \
        else tfm.fused_decode_mlp_partial
    norm = "layer" if arch == "gpt" else "rms"
    return fn(t(d["y1"]), t(d["nw"]), t(d["nb"]), t(d["w1"].T), t(d["b1"]),
              t(d["w2"].T), t(None if d["wu"] is None else d["wu"].T),
              arch=arch, norm=norm, eps=1e-5)


@pytest.mark.parametrize("arch", ["gpt", "llama"])
@pytest.mark.parametrize("B", [1, 5])
def test_partial_plain_matches_jax(arch, B):
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from paddle_tpu.ops.pallas.fused_decode_mlp import \
        fused_decode_mlp_partial
    d = _partial_inputs(arch, B)

    def j(a):
        return None if a is None else jnp.asarray(a)

    ref = fused_decode_mlp_partial(
        j(d["y1"]), j(d["nw"]), j(d["nb"]), j(d["w1"]), j(d["b1"]),
        j(d["w2"]), j(d["wu"]), arch=arch,
        norm="layer" if arch == "gpt" else "rms", eps=1e-5, interpret=True)
    before = tfm.fused_decode_mlp_partial.launches
    got = _port_partial(d, arch)
    assert tfm.fused_decode_mlp_partial.launches == before   # plain on CPU
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["gpt", "llama"])
@pytest.mark.parametrize("B", [1, 5, 9])
def test_partial_kernel_matches_plain_on_card(cuda, arch, B):
    d = _partial_inputs(arch, B)
    before = tfm.fused_decode_mlp_partial.launches
    got = _port_partial(d, arch, cuda)
    torch.cuda.synchronize()
    assert tfm.fused_decode_mlp_partial.launches == before + 1
    torch.testing.assert_close(got, _port_partial(d, arch, cuda, plain=True),
                               **TOL)


@pytest.mark.parametrize("arch", ["gpt", "llama"])
def test_partial_refuses_devices_without_a_kernel(arch):
    """The partial wrapper runs its plain version only for CPU tensors:
    another device gets the kernel or an error, and a launch is counted
    only where the kernel ran."""
    d = _partial_inputs(arch, 3)
    before = tfm.fused_decode_mlp_partial.launches
    with pytest.raises(ValueError, match="no kernel for device meta"):
        _port_partial(d, arch, "meta")
    with pytest.raises(ValueError, match="arch='llama' takes w_up"):
        _port_partial(dict(d, wu=None if arch == "llama" else d["w1"]),
                      arch)
    assert tfm.fused_decode_mlp_partial.launches == before


def test_parallel_env_on_one_rank(tmp_path):
    """The ported environment on a one-rank gloo world: the world group,
    ``new_group``, ranks and sizes for either kind of group, the counted
    in-place sum, and teardown back to no process group."""
    from paddle_tpu_torch import distributed as pdist
    assert not pdist.is_initialized()
    assert (pdist.get_rank(), pdist.get_world_size()) == (0, 1)
    world = pdist.init_parallel_env(
        backend="gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
        world_size=1, rank=0, timeout=timedelta(seconds=WAIT_S))
    try:
        assert pdist.is_initialized() and world.ranks == [0]
        sub = pdist.new_group([0])
        assert sub.id != world.id and pdist.get_group(sub.id) is sub
        for g in (world, sub, sub.process_group):
            assert (pdist.get_rank(g), pdist.get_world_size(g)) == (0, 1)
        with pytest.raises(ValueError, match="not in world"):
            pdist.new_group([1])
        calls = pdist.all_reduce.calls
        t = torch.arange(3.0)
        assert pdist.all_reduce(t, sub) is t
        assert t.tolist() == [0.0, 1.0, 2.0]
        assert pdist.all_reduce.calls == calls + 1
        pdist.destroy_process_group(sub)
    finally:
        pdist.destroy_process_group()
    assert not pdist.is_initialized()
