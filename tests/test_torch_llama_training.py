"""The port's LLaMA training step against the JAX package's.

A tiny LLaMA (the ``tests/test_llama.py`` config: vocab 128, hidden 32,
2 layers, 4 query heads over 2 kv heads; and one MHA case) is built by
the JAX package from its seed; its weights move into the port through
``load_llama_from_jax``, and the same numpy batches (batch 2 x 16) go
through both. On the CPU the JAX rope and fused residual + RMSNorm run
their Pallas kernels in interpret mode and its attention its XLA path;
the port runs the kernels' plain versions.

* fp32 logits and loss within 1e-5, every parameter grad within 1e-4
  (another summation order through two layers), with
  ``train_glue_fusion`` off and on;
* the port with ``recompute=True`` under each ported policy gives the
  grads of no recompute within 1e-6, and ``dots_and_kernels_saveable``
  runs the rope and fused-norm forwards once each (their outputs are
  kept) where the other policies run them again in backward;
* a 3-step AdamW trajectory: losses and final params within 1e-4;
* O2 (bf16 params with the RMSNorm weights, fp32 master weights):
  losses over 2 steps within 2e-2 relative (the two frameworks round to
  bf16 at other places);
* the dtype of every parameter's grad after one O2 backward, glue off
  and on, equals the JAX package's (a bf16 RMSNorm weight that reaches
  the black-listed ``rms_norm`` gets an fp32 grad), and the fp32
  masters of the RMSNorm weights after 3 O2 steps (glue off) are within
  2e-4 of the JAX package's: each step moves them by at most lr = 1e-3,
  and a grad element near zero can point either way after the two
  frameworks' other bf16 roundings;
* ``rope_theta=500000`` changes the logits as it does in JAX;
* the weight round trip is exact.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core import state as tstate
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     llama_state_to_jax, load_llama_from_jax)
from paddle_tpu_torch.nn import RMSNorm
from paddle_tpu_torch.ops.cuda import fused_residual_norm as tfr
from paddle_tpu_torch.ops.cuda import rope as trope

CFG = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
           num_kv_heads=2, max_seq_len=32)
MHA = dict(CFG, num_kv_heads=4)
B, S = 2, 16
POLICIES = ["full", "dots_saveable", "dots_and_kernels_saveable"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests share the machine's cores with
    other test workers, and PyTorch's thread pool, spinning on small ops
    against them, slowed these CPU runs by two orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(n):
    rng = np.random.default_rng(0)
    return [(rng.integers(0, CFG["vocab_size"], (B, S)).astype(np.int64),
             rng.integers(0, CFG["vocab_size"], (B, S)).astype(np.int64))
            for _ in range(n)]


def _jax_weights(cfg):
    import paddle_tpu as paddle
    from paddle_tpu.models.llama import LlamaConfig as JCfg
    from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
    paddle.seed(0)
    jm = JLlama(JCfg(**cfg))
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


@pytest.fixture(scope="module")
def jax_weights():
    pytest.importorskip("jax")
    return _jax_weights(CFG)


def _dtype_name(dt):
    return str(dt).split(".")[-1]


def _jax_train(weights, steps, cfg=CFG, o2=False, glue=False, lr=1e-3):
    """JAX losses, final params and the first step's logits, grads and
    grad dtypes; with ``o2`` also the RMSNorm weights' fp32 masters after
    the last step (``first["norm_masters"]``)."""
    import paddle_tpu as paddle
    from paddle_tpu import amp
    from paddle_tpu.core import state as jstate
    from paddle_tpu.models.llama import LlamaConfig as JCfg
    from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
    from paddle_tpu.nn import functional as JF
    jm = JLlama(JCfg(**cfg))
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in weights.items()})
    jm.train()
    opt = paddle.optimizer.AdamW(learning_rate=lr,
                                 parameters=jm.parameters())
    if o2:
        jm, opt = amp.decorate(models=jm, optimizers=opt, level="O2",
                               dtype="bfloat16", master_weight=True)
    losses, first = [], {}
    old = jstate.get_flag("train_glue_fusion")
    jstate.set_flags({"train_glue_fusion": glue})
    try:
        for ids, lab in _batches(steps):
            with amp.auto_cast(enable=o2, level="O2", dtype="bfloat16"):
                logits = jm.logits(paddle.to_tensor(ids))
                loss = JF.cross_entropy(
                    logits.reshape([-1, cfg["vocab_size"]]),
                    paddle.to_tensor(lab).reshape([-1]))
            loss.backward()
            if not first:
                first = dict(logits=np.asarray(logits.astype("float32")
                                               .numpy()),
                             grads={n: np.asarray(p.grad.astype("float32")
                                                  .numpy())
                                    for n, p in jm.named_parameters()},
                             grad_dtypes={n: _dtype_name(p.grad.dtype)
                                          for n, p in jm.named_parameters()})
            if steps > 1:
                opt.step()
            opt.clear_grad()
            losses.append(float(loss))
    finally:
        jstate.set_flags({"train_glue_fusion": old})
    final = {k: np.asarray(v.astype("float32").numpy())
             for k, v in jm.state_dict().items()}
    if o2:
        first["norm_masters"] = {
            n: np.asarray(opt._master_weights[id(p)]._read())
            for n, p in jm.named_parameters() if "norm" in n}
    return losses, final, first


@pytest.fixture(scope="module")
def jax_fp32_run(jax_weights):
    return _jax_train(jax_weights, 3)


@pytest.fixture(scope="module")
def jax_glue_step(jax_weights):
    return _jax_train(jax_weights, 1, glue=True)


@pytest.fixture(scope="module")
def jax_o2_run(jax_weights):
    return _jax_train(jax_weights, 3, o2=True)


@pytest.fixture(scope="module")
def jax_o2_glue_run(jax_weights):
    return _jax_train(jax_weights, 2, o2=True, glue=True)


class _Glue:
    """``train_glue_fusion`` set for a block, restored after."""

    def __init__(self, on):
        self.on = on

    def __enter__(self):
        self.old = tstate.get_flag("train_glue_fusion")
        tstate.set_flags({"train_glue_fusion": self.on})

    def __exit__(self, *exc):
        tstate.set_flags({"train_glue_fusion": self.old})


def _port_model(weights, cfg=CFG, **kw):
    tm = LlamaForCausalLM(LlamaConfig(**cfg, **kw), device="cpu")
    load_llama_from_jax(tm, weights)
    return tm


def _port_grads(tm):
    return llama_state_to_jax({n: p.grad for n, p in tm.named_parameters()})


def _check_first_step(tm, first, loss0, glue):
    ids, lab = (torch.tensor(x) for x in _batches(1)[0])
    assert tm.training
    with _Glue(glue):
        logits = tm(ids)
        np.testing.assert_allclose(logits.detach().numpy(), first["logits"],
                                   rtol=0, atol=1e-5)
        loss = tm(ids, lab)
        assert abs(float(loss.detach()) - loss0) <= 1e-5
        loss.backward()
    grads = _port_grads(tm)
    assert sorted(grads) == sorted(first["grads"])
    for k, g in first["grads"].items():
        np.testing.assert_allclose(grads[k], g, rtol=0, atol=1e-4,
                                   err_msg=k)


def test_fp32_logits_loss_and_grads_match_jax(jax_weights, jax_fp32_run):
    losses, _, first = jax_fp32_run
    _check_first_step(_port_model(jax_weights), first, losses[0], False)


def test_glue_fused_logits_loss_and_grads_match_jax(jax_weights,
                                                    jax_glue_step):
    losses, _, first = jax_glue_step
    _check_first_step(_port_model(jax_weights), first, losses[0], True)


def test_mha_matches_jax():
    pytest.importorskip("jax")
    weights = _jax_weights(MHA)
    losses, _, first = _jax_train(weights, 1, cfg=MHA)
    _check_first_step(_port_model(weights, cfg=MHA), first, losses[0],
                      False)


def _spy(monkeypatch):
    """Count the forward launches of rope (not its -sin backward) and of
    the fused residual + RMSNorm forward."""
    calls = {"rope": 0, "rms": 0}
    rope, rms = trope.rope, tfr.fused_residual_rms_norm_fwd

    def rope_spy(x, cos, sin, use_neox=True, neg_sin=False):
        calls["rope"] += not neg_sin
        return rope(x, cos, sin, use_neox, neg_sin)

    def rms_spy(*a, **k):
        calls["rms"] += 1
        return rms(*a, **k)
    monkeypatch.setattr(trope, "rope", rope_spy)
    monkeypatch.setattr(tfr, "fused_residual_rms_norm_fwd", rms_spy)
    return calls


@pytest.mark.parametrize("policy", POLICIES)
def test_recompute_policies_keep_grads(jax_weights, policy, monkeypatch):
    ids, lab = (torch.tensor(x) for x in _batches(1)[0])
    with _Glue(True):
        ref = _port_model(jax_weights)
        ref(ids, lab).backward()
        want = _port_grads(ref)
        tm = _port_model(jax_weights, recompute=True,
                         recompute_policy=policy)
        calls = _spy(monkeypatch)
        tm(ids, lab).backward()
    got = _port_grads(tm)
    for k, g in want.items():
        np.testing.assert_allclose(got[k], g, rtol=0, atol=1e-6, err_msg=k)
    L = CFG["num_layers"]
    if policy == "dots_and_kernels_saveable":
        # q and k per layer; the fused norm L - 1 input_norms, L post_norms
        # and the final norm: each once
        assert calls == {"rope": 2 * L, "rms": 2 * L}
    else:
        # run again in backward, except the final norm outside the layers
        assert calls == {"rope": 4 * L, "rms": 4 * L - 1}


def test_adamw_trajectory_fp32_matches_jax(jax_weights, jax_fp32_run):
    jl, jfinal, _ = jax_fp32_run
    tm = _port_model(jax_weights, recompute=True,
                     recompute_policy="dots_and_kernels_saveable")
    opt = topt.AdamW(learning_rate=1e-3, parameters=tm.parameters())
    tl = []
    for ids, lab in _batches(3):
        loss = tm(torch.tensor(ids), torch.tensor(lab))
        loss.backward()
        opt.step()
        opt.clear_grad()
        tl.append(float(loss))
    assert opt._flat and len(opt._flat) == 1
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
    tfinal = llama_state_to_jax(tm.state_dict())
    for k, w in jfinal.items():
        np.testing.assert_allclose(tfinal[k], w, rtol=0, atol=1e-4,
                                   err_msg=k)


def test_o2_losses_match_jax(jax_weights, jax_o2_glue_run):
    jl, _, _ = jax_o2_glue_run
    tm = _port_model(jax_weights, recompute=True,
                     recompute_policy="dots_and_kernels_saveable")
    opt = topt.AdamW(learning_rate=1e-3, parameters=tm.parameters())
    tm, opt = tamp.decorate(models=tm, optimizers=opt, level="O2",
                            dtype="bfloat16", master_weight=True)
    # RMSNorm weights go to bf16 too (only LayerNorm-like layers stay
    # fp32): one bf16 bucket with fp32 masters
    assert tm.llama.norm.weight.dtype == torch.bfloat16
    tl = []
    with _Glue(True):
        for ids, lab in _batches(2):
            with tamp.auto_cast(level="O2", dtype="bfloat16"):
                loss = tm(torch.tensor(ids), torch.tensor(lab))
            assert loss.dtype == torch.float32
            loss.backward()
            opt.step()
            opt.clear_grad()
            tl.append(float(loss))
    assert [(str(g.dtype), g.use_master) for g in opt._flat] == [
        ("torch.bfloat16", True)]
    np.testing.assert_allclose(tl, jl, rtol=2e-2)


def test_rope_theta_changes_logits_as_in_jax(jax_weights, jax_fp32_run):
    import paddle_tpu as paddle
    from paddle_tpu.models.llama import LlamaConfig as JCfg
    from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
    cfg = dict(CFG, rope_theta=500000.0)
    jm = JLlama(JCfg(**cfg))
    jm.set_state_dict({k: paddle.to_tensor(v)
                       for k, v in jax_weights.items()})
    ids = _batches(1)[0][0]
    jlogits = np.asarray(jm.logits(paddle.to_tensor(ids)).numpy())
    tlogits = _port_model(jax_weights, cfg=cfg)(torch.tensor(ids))
    np.testing.assert_allclose(tlogits.detach().numpy(), jlogits, rtol=0,
                               atol=1e-5)
    default = jax_fp32_run[2]["logits"]
    moved = float(np.abs(jlogits - default).max())
    assert moved > 1e-4
    assert abs(float(np.abs(tlogits.detach().numpy() - default).max())
               - moved) <= 1e-5


def test_weight_round_trip(jax_weights):
    tm = _port_model(jax_weights)
    back = llama_state_to_jax(tm.state_dict())
    assert sorted(back) == sorted(jax_weights)
    for k, v in jax_weights.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    # Linear weights are [out, in] in the port, the embedding table not
    assert tuple(tm.lm_head.weight.shape) == (CFG["vocab_size"],
                                              CFG["hidden_size"])
    assert tuple(tm.llama.layers[0].attn.k_proj.weight.shape) == (16, 32)
    assert tuple(tm.llama.embed_tokens.weight.shape) == (128, 32)
    with pytest.raises(KeyError, match="missing keys"):
        load_llama_from_jax(tm, {k: v for k, v in jax_weights.items()
                                 if k != "lm_head.weight"})


def test_tied_weights_and_counts_match_jax():
    pytest.importorskip("jax")
    from paddle_tpu.models.llama import LlamaConfig as JCfg
    from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
    cfg = dict(CFG, tie_embeddings=True)
    weights = _jax_weights(cfg)
    tm = _port_model(weights, cfg=cfg)
    assert tm.lm_head is None
    jm = JLlama(JCfg(**cfg))
    assert tm.num_params() == jm.num_params()
    assert tm.flops_per_token(S) == jm.flops_per_token(S)


def test_config_and_init():
    cfg = LlamaConfig(hidden_size=4096, num_layers=32, num_heads=32)
    assert cfg.num_kv_heads == 32 and cfg.intermediate_size == 11008
    assert cfg.head_dim == 128
    assert LlamaConfig(**CFG).num_kv_heads == 2
    tm = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu",
                          generator=torch.Generator().manual_seed(0))
    assert tm.training and tm.device == torch.device("cpu")
    norms = [m for m in tm.modules() if isinstance(m, RMSNorm)]
    assert len(norms) == 2 * CFG["num_layers"] + 1
    assert all(bool((m.weight == 1).all()) for m in norms)
    assert not any(isinstance(m, torch.nn.LayerNorm) for m in tm.modules())
    resid = 0.02 / np.sqrt(2 * CFG["num_layers"])
    assert abs(float(tm.llama.layers[0].mlp.down_proj.weight.std())
               - resid) < 0.3 * resid


def test_eval_forward_ignores_glue(jax_weights, monkeypatch):
    tm = _port_model(jax_weights)
    ids = torch.tensor(_batches(1)[0][0])
    train_logits = tm(ids)
    tm.eval()
    calls = _spy(monkeypatch)
    with _Glue(True):
        logits = tm(ids)
    assert calls["rms"] == 0 and calls["rope"] == 2 * CFG["num_layers"]
    assert torch.equal(logits, train_logits)


def _port_o2(weights, steps, glue):
    """The port's O2 AdamW run: the first step's grad dtypes (JAX names)
    and the optimizer after ``steps`` steps."""
    tm = _port_model(weights, recompute=True,
                     recompute_policy="dots_and_kernels_saveable")
    opt = topt.AdamW(learning_rate=1e-3, parameters=tm.parameters())
    tm, opt = tamp.decorate(models=tm, optimizers=opt, level="O2",
                            dtype="bfloat16", master_weight=True)
    params = list(tm.named_parameters())
    jnames = llama_state_to_jax({n: torch.zeros(1) for n, _ in params})
    dtypes = None
    with _Glue(glue):
        for ids, lab in _batches(steps):
            with tamp.auto_cast(level="O2", dtype="bfloat16"):
                loss = tm(torch.tensor(ids), torch.tensor(lab))
            loss.backward()
            if dtypes is None:
                dtypes = {j: _dtype_name(tamp.grad_of(p).dtype)
                          for j, (_, p) in zip(jnames, params)}
            opt.step()
            opt.clear_grad()
    return dtypes, dict(zip(jnames, (p for _, p in params))), opt


@pytest.mark.parametrize("glue", [False, True])
def test_o2_grad_dtypes_match_jax(jax_weights, jax_o2_run, jax_o2_glue_run,
                                  glue):
    """Every grad's dtype after one O2 backward equals the JAX package's:
    the RMSNorm weights that reach the black-listed ``rms_norm`` (all of
    them with glue off, layer 0's input_norm with glue on) get fp32
    grads, the rest bf16."""
    want = (jax_o2_glue_run if glue else jax_o2_run)[2]["grad_dtypes"]
    dtypes, _, _ = _port_o2(jax_weights, 1, glue)
    assert dtypes == want
    wide = sorted(k for k, v in want.items() if v == "float32")
    L = CFG["num_layers"]
    assert wide == (["llama.layer_0.input_norm.weight"] if glue else sorted(
        [f"llama.layer_{i}.{n}.weight" for i in range(L)
         for n in ("input_norm", "post_norm")] + ["llama.norm.weight"]))


def test_o2_norm_masters_match_jax(jax_weights, jax_o2_run):
    """After 3 O2 steps (glue off) the RMSNorm weights' fp32 masters,
    updated from their fp32 grads on the per-param path, agree with the
    JAX package's within 2e-4 (see the module docstring)."""
    want = jax_o2_run[2]["norm_masters"]
    _, params, opt = _port_o2(jax_weights, 3, False)
    assert len(want) == 2 * CFG["num_layers"] + 1
    for name, w in want.items():
        got = opt._master_weights[params[name]]
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=2e-4,
                                   err_msg=name)
    # the other params stay in one fused bf16 bucket with fp32 masters
    assert [(str(g.dtype), g.use_master) for g in opt._flat] == [
        ("torch.bfloat16", True)]
