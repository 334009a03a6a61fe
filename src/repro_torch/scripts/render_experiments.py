"""Render the dry run's tables (cells, roofline, baseline against
optimized) as markdown from the JSONs of ``repro_torch.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.scripts.render_experiments \\
        [all|dryrun|roofline|compare] [--dir results/dryrun_torch] \\
        [--opt-dir results/dryrun_torch_opt]

The port's JSONs carry ``trace_s`` (the fake trace's seconds) where the
reference's carry ``compile_s``, and ``ops.collective_counts`` where the
reference's carry ``hlo.collective_counts``.
"""
import argparse
import glob
import json
import os


def load(d):
    rows = {}
    for f in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(f) as fh:
            r = json.load(fh)
        rows[(r["arch"], r["shape"], r["mesh"])] = r
    return rows


def fmt_bytes(b):
    return f"{b/2**30:.2f}"


def dryrun_table(rows):
    out = ["| arch | shape | mesh | GiB/dev | trace s | collectives (counts) |",
           "|---|---|---|---:|---:|---|"]
    for (a, s, m), r in sorted(rows.items()):
        cc = r.get("ops", {}).get("collective_counts", {})
        ccs = " ".join(f"{k.split('-')[-1][:4]}:{v}" for k, v in
                       sorted(cc.items()))
        out.append(f"| {a} | {s} | {m} | "
                   f"{fmt_bytes(r['memory']['peak_per_device_bytes'])} | "
                   f"{r['trace_s']} | {ccs} |")
    return "\n".join(out)


def roofline_table(rows, mesh="16x16"):
    out = ["| arch | shape | t_comp s | t_mem s | t_coll s | bneck | "
           "frac | useful | MODEL_FLOPS | HLO_FLOPs/dev |",
           "|---|---|---:|---:|---:|---|---:|---:|---:|---:|"]
    for (a, s, m), r in sorted(rows.items()):
        if m != mesh or "roofline" not in r:
            continue
        rl = r["roofline"]
        out.append(
            f"| {a} | {s} | {rl['t_compute']:.3f} | {rl['t_memory']:.3f} | "
            f"{rl['t_collective']:.3f} | {rl['bottleneck']} | "
            f"{rl['roofline_fraction']:.3f} | {rl['useful_ratio']:.3f} | "
            f"{rl['model_flops']:.2e} | {rl['flops_per_dev']:.2e} |")
    return "\n".join(out)


def compare(base, opt):
    out = ["| cell | metric | baseline | optimized | change |",
           "|---|---|---:|---:|---:|"]
    for key, ro in sorted(opt.items()):
        a, s, m = key
        rb = base.get(key)
        if rb is None or "roofline" not in ro:
            continue
        for metric, fmt in (("t_compute", "{:.3f}"), ("t_memory", "{:.3f}"),
                            ("t_collective", "{:.3f}"),
                            ("roofline_fraction", "{:.4f}")):
            b = rb["roofline"][metric]
            o = ro["roofline"][metric]
            chg = (f"{b/o:.1f}x better" if metric != "roofline_fraction"
                   and o < b and o > 0 else
                   f"{o/b:.1f}x better" if metric == "roofline_fraction"
                   and b > 0 and o > b else f"{o/b:.2f}x" if b else "-")
            out.append(f"| {a}/{s} | {metric} | {fmt.format(b)} | "
                       f"{fmt.format(o)} | {chg} |")
        bmem = rb["memory"]["peak_per_device_bytes"] / 2**30
        omem = ro["memory"]["peak_per_device_bytes"] / 2**30
        out.append(f"| {a}/{s} | mem GiB/dev | {bmem:.2f} | {omem:.2f} | "
                   f"{bmem/omem:.1f}x better |")
    return "\n".join(out)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", nargs="?", default="all",
                    choices=["all", "dryrun", "roofline", "compare"])
    ap.add_argument("--dir", default="results/dryrun_torch")
    ap.add_argument("--opt-dir", default="results/dryrun_torch_opt")
    args = ap.parse_args(argv)
    base = load(args.dir)
    tables = {}
    if args.mode in ("all", "dryrun"):
        tables["dryrun"] = dryrun_table(base)
        print("## single-pod + multi-pod dry-run\n")
        print(tables["dryrun"])
    if args.mode in ("all", "roofline"):
        tables["roofline"] = roofline_table(base)
        print("\n## roofline (single-pod)\n")
        print(tables["roofline"])
    if args.mode in ("all", "compare") and os.path.isdir(args.opt_dir):
        tables["compare"] = compare(base, load(args.opt_dir))
        print("\n## baseline vs optimized\n")
        print(tables["compare"])
    return tables


if __name__ == "__main__":
    main()
