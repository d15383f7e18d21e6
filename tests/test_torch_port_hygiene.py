"""The port stands alone: no JAX, no ``paddle_tpu``, no silent CPU
fallback, and a clear error where the CUDA toolchain is missing."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch.ops.cuda import _build

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "chip_ab.py"]
BANNED = ("jax", "jaxlib", "paddle_tpu")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_roots(path) if m in BANNED]
    assert not bad, f"{path.name} imports {bad}"


def test_import_pulls_in_no_jax():
    code = ("import sys\n"
            "import paddle_tpu_torch.inference, paddle_tpu_torch.models\n"
            "import paddle_tpu_torch.ops.cuda.paged_attention\n"
            "import paddle_tpu_torch.ops.cuda.flash_attention\n"
            "import paddle_tpu_torch.ops.cuda.fused_optimizer\n"
            "import paddle_tpu_torch.ops.cuda._build\n"
            "import paddle_tpu_torch.amp, paddle_tpu_torch.optimizer\n"
            "import paddle_tpu_torch.nn.functional\n"
            "import paddle_tpu_torch.distributed.fleet\n"
            "import paddle_tpu_torch.core.dtype\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_no_card_no_fallback(monkeypatch):
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    cfg = GPTConfig(vocab_size=32, hidden_size=16, num_layers=1,
                    num_heads=2, max_seq_len=16)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        paddle_tpu_torch.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA card"):
        GPTForCausalLM(cfg)
    model = GPTForCausalLM(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA card"):
        ContinuousBatchingEngine(model, max_slots=1, page_size=4)
    eng = ContinuousBatchingEngine(model, max_slots=1, page_size=4,
                                   decode_window=2, prefill_chunk=4,
                                   q_block=2, device="cpu")
    eng.add_request([1, 2, 3], 3)
    (done,) = eng.run().values()
    assert done.finish_reason == "length" and done.tokens.size == 3


def test_kernel_wrappers_refuse_devices_without_a_kernel():
    """The training slice's wrappers run their plain version only for
    CPU tensors; any other device gets the kernel or an error."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import fused_optimizer as fo

    wrappers = (fa.flash_attention_fwd, fa.flash_attention_bwd,
                fo.fused_update)
    before = [w.launches for w in wrappers]
    x = torch.zeros(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fa.flash_attention_fwd(x, x, x)
    lse = torch.zeros(1, 2, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fa.flash_attention_bwd(x, x, x, x, x, lse)
    w = torch.zeros(1024, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fo.fused_update(fo.UpdateSpec(kind="sgd"), w=w, g=w, lr=0.1)
    assert [w.launches for w in wrappers] == before


def test_engine_refuses_a_model_on_another_device():
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    model = GPTForCausalLM(GPTConfig(vocab_size=32, hidden_size=16,
                                     num_layers=1, num_heads=2,
                                     max_seq_len=16), device="cpu")
    with pytest.raises(ValueError, match="model lives on"):
        ContinuousBatchingEngine(model, device="meta")


def test_chip_smoke_serve_phase_rehearses_on_cpu():
    """chip_smoke's serve phase (engine drive, pool checks, teacher-forced
    check against a plain forward) at a tiny width on the CPU."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    from paddle_tpu_torch.models import GPTConfig

    cfg = GPTConfig(vocab_size=128, hidden_size=32, num_layers=2,
                    num_heads=4, max_seq_len=96)
    out = chip_smoke.serve_phase(0, cfg=cfg, device="cpu")
    assert out["tokens"] == 16 * 32 and out["launches"] == 0


def test_chip_smoke_train_phase_rehearses_on_cpu():
    """chip_smoke's train phase (O2 AdamW steps through the Paddle entry
    points, loss and finiteness checks) at a tiny width on the CPU."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    from paddle_tpu_torch.models import GPTConfig

    cfg = GPTConfig(vocab_size=128, hidden_size=32, num_layers=2,
                    num_heads=4, max_seq_len=32, recompute=True,
                    recompute_policy="dots_and_kernels_saveable")
    out = chip_smoke.train_phase(0, cfg=cfg, device="cpu", batch=2,
                                 seq=32, warmup=1, steps=2)
    assert len(out["losses"]) == 3 and out["buckets"] == 2
    assert out["mfu"] is None and set(out["counts"].values()) == {0}


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "NVCC_FALLBACKS",
                        (str(tmp_path / "nvcc"),))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found") as ei:
        _build.build_all()
    assert "sm_90a" in str(ei.value)
    assert _build.sources() == ["flash_attention", "fused_optimizer",
                                "paged_attention"]


def test_failed_build_names_command_and_stderr(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: fake compiler said no' >&2\n"
                    "exit 2\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError) as ei:
        _build.build_all(["paged_attention"])
    msg = str(ei.value)
    assert "fake compiler said no" in msg and "paged_attention.cu" in msg
    assert "arch=compute_90a,code=sm_90a" in msg
    assert not list((tmp_path / "build").glob("*"))


@pytest.mark.parametrize("name", ["flash_attention", "fused_optimizer"])
def test_failed_build_of_training_kernels_raises(monkeypatch, tmp_path,
                                                 name):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: fake compiler said no' >&2\n"
                    "exit 2\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError) as ei:
        _build.load(name)
    msg = str(ei.value)
    assert f"$ {fake}" in msg and f"{name}.cu" in msg
    assert "fake compiler said no" in msg
    assert "arch=compute_90a,code=sm_90a" in msg
