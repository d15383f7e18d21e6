"""The port's GPT training step against the JAX package's.

A tiny GPT (2 layers, hidden 64, 4 heads, vocab 128, S 32, batch 2) is
built by the JAX package from its seed; its weights move into the port
through ``load_gpt_from_jax``, and the same numpy batches go through
both. On the CPU the JAX attention is its plain XLA path and the port's
is the flash kernel's plain version.

* fp32 logits and loss within 1e-5, every parameter grad within 1e-4
  (another summation order through two layers);
* the port with ``recompute=True`` under each ported policy gives the
  grads of no recompute within 1e-6, and ``dots_and_kernels_saveable``
  runs the attention forward once per layer (its output is kept);
* a 3-step AdamW trajectory: losses and final params within 1e-4;
* O2 (bf16 params, fp32 master weights): losses over 3 steps within
  2e-2 relative (the two frameworks round to bf16 at other places).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core import state as tstate
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     gpt_state_to_jax, load_gpt_from_jax)
from paddle_tpu_torch.ops.cuda import flash_attention as tfa

CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=32, dropout=0.0)
B, S = 2, 32
POLICIES = ["full", "dots_saveable", "dots_and_kernels_saveable"]


@pytest.fixture(scope="module")
def jax_weights():
    pytest.importorskip("jax")
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt import GPTConfig as JCfg
    from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
    paddle.seed(0)
    jm = JGPT(JCfg(**CFG))
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _batches(n):
    rng = np.random.default_rng(0)
    return [(rng.integers(0, CFG["vocab_size"], (B, S)).astype(np.int64),
             rng.integers(0, CFG["vocab_size"], (B, S)).astype(np.int64))
            for _ in range(n)]


def _jax_model(weights, **kw):
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt import GPTConfig as JCfg
    from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
    jm = JGPT(JCfg(**CFG, **kw))
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in weights.items()})
    jm.train()
    return jm


def _port_model(weights, **kw):
    tm = GPTForCausalLM(GPTConfig(**CFG, **kw), device="cpu")
    load_gpt_from_jax(tm, weights)
    return tm


def _port_grads(tm):
    return gpt_state_to_jax({n: p.grad for n, p in tm.named_parameters()})


def _jax_train(weights, steps, o2=False, lr=1e-3):
    """Losses, final params and the first step's logits and grads."""
    import paddle_tpu as paddle
    from paddle_tpu import amp
    from paddle_tpu.nn import functional as JF
    jm = _jax_model(weights)
    opt = paddle.optimizer.AdamW(learning_rate=lr,
                                 parameters=jm.parameters())
    if o2:
        jm, opt = amp.decorate(models=jm, optimizers=opt, level="O2",
                               dtype="bfloat16", master_weight=True)
    losses, first = [], {}
    for ids, lab in _batches(steps):
        with amp.auto_cast(enable=o2, level="O2", dtype="bfloat16"):
            # forward(ids, labels) as logits + cross-entropy, to keep
            # the logits of the first step
            logits = jm.logits(paddle.to_tensor(ids))
            loss = JF.cross_entropy(
                logits.reshape([-1, CFG["vocab_size"]]),
                paddle.to_tensor(lab).reshape([-1]))
        loss.backward()
        if not first:
            first = dict(logits=np.asarray(logits.numpy()),
                         grads={n: np.asarray(p.grad.numpy()) for n, p in
                                jm.named_parameters()})
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    final = {k: np.asarray(v.numpy()).astype(np.float32)
             for k, v in jm.state_dict().items()}
    return losses, final, first


@pytest.fixture(scope="module")
def jax_fp32_run(jax_weights):
    return _jax_train(jax_weights, 3)


def _port_train(weights, steps, o2=False, lr=1e-3, **kw):
    tm = _port_model(weights, **kw)
    opt = topt.AdamW(learning_rate=lr, parameters=tm.parameters())
    if o2:
        tm, opt = tamp.decorate(models=tm, optimizers=opt, level="O2",
                                dtype="bfloat16", master_weight=True)
    losses = []
    for ids, lab in _batches(steps):
        with tamp.auto_cast(enable=o2, level="O2", dtype="bfloat16"):
            loss = tm(torch.tensor(ids), torch.tensor(lab))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses, gpt_state_to_jax(tm.state_dict()), opt


def test_fp32_logits_loss_and_grads_match_jax(jax_weights, jax_fp32_run):
    jlosses, _, first = jax_fp32_run
    ids, lab = _batches(1)[0]
    tm = _port_model(jax_weights)
    assert tm.training
    logits = tm(torch.tensor(ids))
    np.testing.assert_allclose(logits.detach().numpy(), first["logits"],
                               rtol=0, atol=1e-5)
    loss = tm(torch.tensor(ids), torch.tensor(lab))
    assert abs(float(loss.detach()) - jlosses[0]) <= 1e-5
    loss.backward()
    grads = _port_grads(tm)
    assert sorted(grads) == sorted(first["grads"])
    for k, g in first["grads"].items():
        np.testing.assert_allclose(grads[k], g, rtol=0, atol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("policy", POLICIES)
def test_recompute_policies_keep_grads(jax_weights, policy, monkeypatch):
    ids, lab = (torch.tensor(x) for x in _batches(1)[0])
    ref = _port_model(jax_weights)
    ref(ids, lab).backward()
    want = _port_grads(ref)
    tm = _port_model(jax_weights, recompute=True, recompute_policy=policy)
    calls = []
    plain = tfa.flash_attention_fwd_plain
    monkeypatch.setattr(tfa, "flash_attention_fwd_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    tm(ids, lab).backward()
    got = _port_grads(tm)
    for k, g in want.items():
        np.testing.assert_allclose(got[k], g, rtol=0, atol=1e-6, err_msg=k)
    # the attention forward runs again in backward unless it is kept
    kept = policy == "dots_and_kernels_saveable"
    assert len(calls) == CFG["num_layers"] * (1 if kept else 2)


def test_recompute_refuses_other_policies(jax_weights):
    ids, lab = (torch.tensor(x) for x in _batches(1)[0])
    for policy, exc in (("transformer_saveable", NotImplementedError),
                        ("no_such_policy", ValueError)):
        tm = _port_model(jax_weights, recompute=True,
                         recompute_policy=policy)
        with pytest.raises(exc, match=policy):
            tm(ids, lab)


def test_adamw_trajectory_fp32_matches_jax(jax_weights, jax_fp32_run):
    jl, jfinal, _ = jax_fp32_run
    tl, tfinal, opt = _port_train(jax_weights, 3, recompute=True,
                                  recompute_policy="dots_and_kernels_saveable")
    assert opt._flat and len(opt._flat) == 1
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
    for k, w in jfinal.items():
        np.testing.assert_allclose(tfinal[k], w, rtol=0, atol=1e-4,
                                   err_msg=k)


def test_adamw_trajectory_o2_matches_jax(jax_weights):
    jl, _, _ = _jax_train(jax_weights, 3, o2=True)
    tl, _, opt = _port_train(jax_weights, 3, o2=True, recompute=True,
                             recompute_policy="dots_and_kernels_saveable")
    # two buckets: bf16 with fp32 masters, fp32 LayerNorm params
    assert sorted((str(g.dtype), g.use_master) for g in opt._flat) == [
        ("torch.bfloat16", True), ("torch.float32", False)]
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
    assert tl[-1] < tl[0]


def test_o2_casts_at_functional_boundaries(jax_weights):
    tm = _port_model(jax_weights)
    opt = topt.AdamW(parameters=tm.parameters())
    tm, opt = tamp.decorate(models=tm, optimizers=opt, level="O2",
                            dtype="bfloat16")
    assert opt._multi_precision
    assert tm.gpt.wte.weight.dtype == torch.bfloat16
    assert tm.gpt.blocks[0].ln1.weight.dtype == torch.float32
    ids, lab = (torch.tensor(x) for x in _batches(1)[0])
    with tamp.auto_cast(level="O2", dtype="bfloat16"):
        logits = tm(ids)
        loss = tm(ids, lab)
    assert logits.dtype == torch.bfloat16 and loss.dtype == torch.float32
    loss.backward()
    assert tm.gpt.wte.weight.grad.dtype == torch.bfloat16
    assert tm.gpt.ln_f.weight.grad.dtype == torch.float32


def test_unfused_attention_backend_matches_the_kernel_path(jax_weights):
    """``use_flash_attention=False`` routes attention to the plain
    softmax path (``backend="xla"``); fp32 logits agree within 1e-5."""
    ids = torch.tensor(_batches(1)[0][0])
    flash = _port_model(jax_weights)(ids)
    plain = _port_model(jax_weights, use_flash_attention=False)(ids)
    np.testing.assert_allclose(plain.detach().numpy(),
                               flash.detach().numpy(), rtol=0, atol=1e-5)


def test_refusals():
    with pytest.raises(NotImplementedError, match="MoE"):
        GPTForCausalLM(GPTConfig(**CFG, num_experts=2), device="cpu")
    tm = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    ids = torch.zeros(1, 4, dtype=torch.long)
    tstate.set_flags({"train_glue_fusion": True})
    try:
        with pytest.raises(NotImplementedError, match="#9-#12"):
            tm(ids)
        tm.eval()
        assert tm(ids).shape == (1, 4, CFG["vocab_size"])
    finally:
        tstate.set_flags({"train_glue_fusion": False})
    with pytest.raises(NotImplementedError, match="dropout"):
        GPTForCausalLM(GPTConfig(**dict(CFG, dropout=0.1)),
                       device="cpu")(ids)
