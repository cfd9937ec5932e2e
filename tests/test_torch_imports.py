"""The port stands alone: it imports neither JAX nor the reference
package (its analysis layer and lint included), and neither does
chip_smoke.py."""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
IMPORT_RE = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|from\s+repro(\.|\s))",
    re.MULTILINE)


def test_port_sources_import_no_jax_or_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    assert {"invariants.py", "hooks.py", "differential.py", "lint.py"} <= {
        f.name for f in files if f.parent.name == "analysis"}
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if IMPORT_RE.search(f.read_text())]
    assert offenders == []


def test_engine_on_cpu_loads_no_jax_or_reference_module():
    code = """
import sys, torch
from repro_torch.configs import ServeConfig, get_config
from repro_torch.core.engine import Engine, Request
from repro_torch.core.sampler import SamplingParams
from repro_torch.models.registry import get_model
model = get_model("qwen3-0.6b", get_config("qwen3-0.6b").reduced())
params = model.init(torch.Generator().manual_seed(0), device="cpu")
eng = Engine(model, params, ServeConfig(mode="splitwiser_mps", max_batch=2,
             page_size=4, n_pages=32, max_pages_per_seq=8, prefill_chunk=4,
             sanitize_level="off", dispatch_sentinel=False), device="cpu")
eng.run([Request(rid=0, prompt=[5, 6, 7, 8, 9],
                 sampling=SamplingParams(max_new_tokens=3))])
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "repro.")))
assert not bad, bad
assert len(eng.poll()[0].tokens) == 3
print("clean")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_analysis_layer_loads_no_jax_or_reference_module():
    """The sanitizer at its finest level over an int8 engine, in a fresh
    interpreter: still nothing of JAX or the reference is loaded."""
    code = """
import sys, torch
import repro_torch.analysis
from repro_torch.configs import ServeConfig, get_config
from repro_torch.core.engine import Engine, Request
from repro_torch.core.sampler import SamplingParams
from repro_torch.models.registry import get_model
model = get_model("qwen3-0.6b", get_config("qwen3-0.6b").reduced())
params = model.init(torch.Generator().manual_seed(0), device="cpu")
eng = Engine(model, params, ServeConfig(mode="chunked", max_batch=2, page_size=4,
             n_pages=32, max_pages_per_seq=8, chunk_tokens=8, kv_dtype="int8",
             enable_prefix_cache=True, sanitize_level="call",
             dispatch_sentinel=False), device="cpu")
eng.run([Request(rid=0, prompt=[5, 6, 7, 8, 9],
                 sampling=SamplingParams(max_new_tokens=3))])
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "repro.")))
assert not bad, bad
assert eng.sanitizer.n_checks > 0 and len(eng.poll()[0].tokens) == 3
print("clean")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_hybrid_on_cpu_loads_no_jax_or_reference_module():
    """A reduced zamba2 prefill and decode step (the SSD scan's and the
    attention kernels' plain versions), in a fresh interpreter."""
    code = """
import sys, torch
from repro_torch.configs import get_config
from repro_torch.models import hybrid, transformer
from repro_torch.models.registry import get_model
model = get_model("zamba2-7b", get_config("zamba2-7b").reduced())
params = model.init(torch.Generator().manual_seed(0), device="cpu")
toks = torch.randint(0, model.cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(1))
last, (k, v), (conv, ssm) = hybrid.prefill(params, model.cfg, toks)
free = torch.zeros((1, 3, 4) + tuple(k.shape[-2:]))
kpg = torch.cat([transformer.kv_to_pages(k, 4), free], 1)     # pages 4, 5 free, 6 trash
vpg = torch.cat([transformer.kv_to_pages(v, 4), free], 1)
bt = torch.tensor([[0, 1, 4], [2, 3, 5]], dtype=torch.int32)
logits, _, _ = hybrid.decode(params, model.cfg, last.argmax(-1), conv, ssm,
                             kpg, vpg, bt, torch.full((2,), 8))
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "repro.")))
assert not bad, bad
assert logits.shape == (2, 256) and bool(torch.isfinite(logits).all())
print("clean")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_rwkv_encdec_and_launcher_load_no_jax_or_reference_module():
    """A reduced rwkv6 prefill and decode step, a reduced seamless-m4t
    prefill and paged decode step, and the serving launcher's ``main`` on
    the CPU, in a fresh interpreter."""
    code = """
import sys, torch
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import encdec, rwkv, transformer
from repro_torch.models.registry import get_model
g = torch.Generator().manual_seed(1)
m = get_model("rwkv6-7b", get_config("rwkv6-7b").reduced())
p = m.init(torch.Generator().manual_seed(0), device="cpu")
last, st = rwkv.prefill(p, m.cfg, torch.randint(0, 256, (2, 8), generator=g))
logits, st = rwkv.decode(p, m.cfg, last.argmax(-1), st)
assert logits.shape == (2, 256) and bool(torch.isfinite(logits).all())
m = get_model("seamless-m4t-medium", get_config("seamless-m4t-medium").reduced())
p = m.init(torch.Generator().manual_seed(0), device="cpu")
frames = torch.randn(2, 12, m.cfg.d_model, generator=g) * 0.3
last, (k, v), (xk, xv) = encdec.prefill(p, m.cfg, frames, torch.randint(0, 256, (2, 8), generator=g))
free = torch.zeros((k.shape[0], 3, 4) + tuple(k.shape[-2:]))
kpg = torch.cat([transformer.kv_to_pages(k, 4), free], 1)     # pages 4, 5 free, 6 trash
vpg = torch.cat([transformer.kv_to_pages(v, 4), free], 1)
bt = torch.tensor([[0, 1, 4], [2, 3, 5]], dtype=torch.int32)
logits, _ = encdec.decode(p, m.cfg, last.argmax(-1), kpg, vpg, xk, xv, bt, torch.full((2,), 8))
assert logits.shape == (2, 256) and bool(torch.isfinite(logits).all())
serve.main(["--reduced", "--device", "cpu", "--n-requests", "2", "--input-tokens", "8",
            "--output-tokens", "2"])
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "repro.")))
assert not bad, bad
print("clean")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "clean"


def test_training_loads_no_jax_or_reference_module(tmp_path):
    """The training launcher's ``main`` (Trainer, losses, AdamW with int8
    moments, checkpoints) on the CPU, then a resume from its checkpoint,
    in a fresh interpreter: still nothing of JAX or the reference."""
    code = f"""
import sys
from repro_torch.launch import train
args = ["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu", "--steps", "2",
        "--batch", "2", "--seq", "16", "--int8-moments", "--ckpt-every", "1",
        "--ckpt-dir", {str(tmp_path / "ckpt")!r}]
train.main(args)
train.main(args[:6] + ["3"] + args[7:])          # 3 steps: resumes at 2
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "repro.")))
assert not bad, bad
print("clean")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "clean"
    assert "start_step=2" in out.stdout and sum(x.startswith("done:") for x in lines) == 2


def test_cost_model_and_dry_run_load_no_jax_or_reference_module():
    """The six modules of the analysis layer (hardware spec, cost model,
    roofline, cell builders, dry run, Splitwise baseline), in a fresh
    interpreter: nothing of JAX or the reference is loaded, and importing
    the dry run sets no environment variable (the reference's sets
    XLA_FLAGS)."""
    code = """
import os, sys
env = dict(os.environ)
import repro_torch.launch.dryrun
from repro_torch.common import hw
from repro_torch.launch import costs, roofline, splitwise, steps
assert dict(os.environ) == env
import torch
c = costs.traced_costs(lambda a, b: a @ b, torch.zeros(8, 32), torch.zeros(32, 16))
assert c["flops"] == 2 * 8 * 32 * 16, c
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "repro.")))
assert not bad, bad
print("clean")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_mesh_modules_load_no_jax_or_reference_module():
    """The mesh path's four modules (``launch/{mesh,shardings,spmd}.py``,
    ``models/sharding.py``) in a fresh interpreter: nothing of JAX or the
    reference is loaded and no environment variable is set."""
    code = """
import os, sys
env = dict(os.environ)
from repro_torch.launch import mesh, shardings, spmd
from repro_torch.models import sharding
assert dict(os.environ) == env
assert mesh.make_production_mesh() == ((16, 16), ("data", "model"))
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "repro.")))
assert not bad, bad
print("clean")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
