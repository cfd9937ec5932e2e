"""The port's one-card dry run (``repro_torch.launch.{steps,dryrun,
splitwise}``) against the reference's cell builders on the CPU: the same
cells are supported or skipped for the same reasons, each family's cell
takes arguments of the reference's shapes and dtypes (at tp = 1, one data
shard), and the CLI traces a full-size cell under fake tensors."""
import json

import jax
import pytest
import torch

from repro.configs.registry import ASSIGNED
from repro.launch import steps as jax_steps
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, splitwise, steps
from repro_torch.launch.costs import traced_costs

# one arch of each family
FAMILY_ARCHS = ["qwen3-0.6b", "olmoe-1b-7b", "internvl2-2b", "seamless-m4t-medium",
                "zamba2-7b", "rwkv6-7b"]


def test_cell_supported_matches_reference():
    from repro.configs import get_config as jax_get_config
    for arch in ASSIGNED:
        for shape in dryrun.SHAPE_ORDER:
            assert steps.cell_supported(get_config(arch), shape) == \
                jax_steps.cell_supported(jax_get_config(arch), shape), (arch, shape)
    assert steps.SHAPES == jax_steps.SHAPES


def _leaf_specs(tree, prefix=""):
    """path -> (shape, dtype name) over nested dicts/lists/tuples of
    tensors or ShapeDtypeStructs."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaf_specs(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaf_specs(v, f"{prefix}/{i}"))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_build_cell_matches_reference_args_or_reason(arch):
    """decode_32k's arguments (params included) have the reference's
    shapes and dtypes on a 1 x 1 mesh; every other shape builds or skips
    with the reference's reason."""
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    cell, why = steps.build_cell(arch, "decode_32k")
    want, _ = jax_steps.build_cell(arch, "decode_32k", mesh)
    assert why == "" and set(cell) == {"fn", "args", "make_args", "note"}
    assert _leaf_specs(cell["args"]) == _leaf_specs(want["args"])
    for shape in ("long_500k", "mixed_32k"):
        ok, reason = jax_steps.cell_supported(jax_steps.get_config(arch), shape)
        if not ok:
            assert steps.build_cell(arch, shape) == (None, reason)


def test_dryrun_cli_decode_32k(tmp_path, capsys):
    out = tmp_path / "rows.jsonl"
    assert dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k",
                        "--out", str(out)]) == 0
    row = json.loads(out.read_text())
    assert row["status"] == "ok" and row["mesh"] == "h100" and row["n_devices"] == 1
    assert row["bottleneck"] == "memory" and not row["fits_hbm"]
    assert row["t_collective_s"] == 0.0 and row["coll_breakdown"] == {}
    assert 0 < row["useful_ratio"] < 1 and row["flops_per_dev"] > row["model_flops"]
    assert "0 FAILED of 1 cells" in capsys.readouterr().out


def test_mixed_kv8_cell_traces_with_int8_pages(monkeypatch):
    """The kv8 scheme's pools are {"q": int8, "s": f32} dicts: the cell
    moves fewer bytes than the fp one and does the dequantize's FLOPs."""
    monkeypatch.setitem(steps.SHAPES, "mixed_32k",
                        dict(kind="mixed", seq=256, batch=2, chunk=32, streams=1))
    cells = {s: steps.build_mixed("qwen3-0.6b", scheme=s) for s in ("baseline", "kv8")}
    pools = cells["kv8"]["args"][2]
    assert pools["q"].dtype == torch.int8 and pools["s"].dtype == torch.float32
    cost = {s: traced_costs(c["fn"], *c["args"]) for s, c in cells.items()}
    assert cost["kv8"]["flops"] > cost["baseline"]["flops"]    # the dequantize
    assert cost["kv8"]["bytes"] < cost["baseline"]["bytes"]


def test_splitwise_handoff_bytes(monkeypatch):
    monkeypatch.setitem(steps.SHAPES, "prefill_32k", dict(kind="prefill", seq=256, batch=2))
    monkeypatch.setitem(steps.SHAPES, "decode_32k", dict(kind="decode", seq=256, batch=2))
    cfg = get_config("qwen3-0.6b")
    out = splitwise.analyze_splitwise("qwen3-0.6b", verbose=False)
    assert out["kv_handoff_bytes_per_req"] == \
        2 * cfg.n_layers * 32768 * cfg.n_kv_heads * cfg.head_dim * 2
    assert out["t_handoff_per_req_s"] == out["kv_handoff_bytes_per_req"] / 25e9
    assert out["prefill_mem_GiB"] > 0 and out["decode_mem_GiB"] > 0
