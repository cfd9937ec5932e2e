"""Phase disaggregation on two cards — the Splitwise [5] baseline, for
comparison against same-card Splitwiser.

Card 0 runs the prompt phase (the prefill cell), card 1 the token phase
(the decode cell); the KV cache is handed off between them.  This module
traces both cells through the one-card dry run, as if each ran on its
own H100, and reports their peak memory and the handoff cost per request
— the quantity Splitwiser eliminates by co-locating the phases (paper
§I: "minimize network-related overheads").  The counterpart of the
reference's ``launch/splitwise.py`` (two pods of a TPU mesh there).

    PYTHONPATH=src python -m repro_torch.launch.splitwise --arch qwen3-0.6b
"""
import argparse


def analyze_splitwise(arch: str, *, seq=32768, verbose=True):
    from repro_torch.common.hw import H100_SXM
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.launch.costs import traced_costs
    from repro_torch.models import hybrid

    pcell = steps.build_prefill(arch)          # prompt phase, card 0
    dcell = steps.build_decode(arch)           # token phase, card 1
    p_cost = traced_costs(pcell["fn"], *pcell["args"])
    d_cost = traced_costs(dcell["fn"], *dcell["args"])

    # KV handoff: per request, the prefill card ships the full prompt KV
    # to the decode card (k + v, bf16, unpadded heads on one card each)
    cfg = get_config(arch)
    layers = cfg.n_layers if cfg.family != "hybrid" else hybrid.group_structure(cfg)[0]
    kv_bytes_per_req = 2 * layers * seq * cfg.n_kv_heads * cfg.head_dim * 2
    t_handoff = kv_bytes_per_req / H100_SXM.ici_bw_per_link
    out = dict(
        arch=arch,
        prefill_mem_GiB=p_cost["peak_bytes"] / 2**30,
        decode_mem_GiB=d_cost["peak_bytes"] / 2**30,
        kv_handoff_bytes_per_req=kv_bytes_per_req,
        t_handoff_per_req_s=t_handoff,
    )
    if verbose:
        print(f"[splitwise x {arch}] prefill(card 0) + decode(card 1), each "
              f"traced as on its own H100: peak {out['prefill_mem_GiB']:.2f} / "
              f"{out['decode_mem_GiB']:.2f} GiB")
        print(f"  KV handoff: {kv_bytes_per_req/2**30:.2f} GiB/request "
              f"-> {t_handoff*1e3:.1f} ms/request over one "
              f"{H100_SXM.ici_bw_per_link/1e9:.0f} GB/s NVLink link")
        print(f"  (Splitwiser's same-card mixed batching pays ZERO handoff; "
              f"this is the paper's motivating overhead)")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    args = ap.parse_args(argv)
    analyze_splitwise(args.arch)


if __name__ == "__main__":
    main()
