"""The port stands alone: it imports neither JAX nor the reference
package, and neither does chip_smoke.py."""
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
