"""JAX references that the port's serving tests share (no tests here).

:func:`jax_gpt` draws the JAX package's GPT as those tests draw it, and
:func:`jax_gpt_beside` serves it in a spawned process (its JAX CPU backend
comes anew from the environment the test process set) while the test's
own process does other work, so that a module's slowest JAX references
compile side by side.
"""
import multiprocessing as mp
import pickle
from pathlib import Path

import numpy as np

WAIT_S = 600   # a spawned JAX reference, at most


def jax_gpt(cfg):
    """The JAX ``GPTForCausalLM`` of ``cfg`` (no dropout), drawn from
    seed 0, in eval mode."""
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt import GPTConfig, GPTForCausalLM
    paddle.seed(0)
    model = GPTForCausalLM(GPTConfig(**cfg, dropout=0.0))
    model.eval()
    return model


def named_arrays(model):
    """A JAX model's ``state_dict()`` as numpy arrays by name."""
    return {k: np.asarray(v.numpy()) for k, v in model.state_dict().items()}


def _gpt_main(path, cfg, workloads):
    import jax
    jax.config.update("jax_platforms", "cpu")
    from paddle_tpu.inference import ContinuousBatchingEngine
    model = jax_gpt(cfg)
    res = workloads(lambda **kw: ContinuousBatchingEngine(model, **kw))
    Path(path).write_bytes(pickle.dumps((res, named_arrays(model))))


def jax_gpt_beside(tmp, cfg, workloads, named, work):
    """``workloads(make_engine)`` on the JAX GPT of ``cfg`` in a spawned
    process (``workloads`` a module-level function, so that the process
    can import it), while ``work()`` runs here. The spawned model's
    weights must equal ``named``, the test's own draw. Returns
    ``(workloads' result, work's result)``."""
    path = Path(tmp) / "jax_gpt.pkl"
    proc = mp.get_context("spawn").Process(
        target=_gpt_main, args=(str(path), cfg, workloads))
    proc.start()
    try:
        mine = work()
    finally:
        proc.join(WAIT_S)
        if proc.is_alive():
            proc.kill()
            proc.join(10)
    assert proc.exitcode == 0, f"the JAX GPT reference exited {proc.exitcode}"
    res, got = pickle.loads(path.read_bytes())
    assert got.keys() == named.keys() and all(
        np.array_equal(v, named[k]) for k, v in got.items())
    return res, mine
