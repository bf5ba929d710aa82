"""Ratio comparison table of the port against external compressors
(counterpart of cpprcoder_tpu/bench/compare.py, with its `build`,
`to_markdown` and `main`).

Produces a Markdown table and its JSON, written where `--out` names
(`<out>.md`, `<out>.json`); it refuses to write over the JAX package's
COMPARISON.md / COMPARISON.json at the repository root:
  - the port's codecs' per-file ratios from containers that round-trip
    (a ratio does not depend on how it is timed, and every backend writes
    the same containers);
  - external rows (zlib, bzip2, xz from the standard library) with their
    host MB/s;
  - the reference's published ratios for context (BASELINE.md).

Run:  python -m cpprcoder_tpu_torch.bench.compare --out OUT [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

CT_DEFAULT = ("rcx", "rcq", "adaptive_range", "static_range", "rans",
              "huffman", "slz4")
PIPELINES = {"bwt_pipeline": ["blocksort", "mtf1", "rle0", "adaptive_range"]}
ROOT = Path(__file__).resolve().parents[2]


def build(ct_codecs=CT_DEFAULT, pipelines=PIPELINES, files=None,
          backend: str | None = None, device=None) -> dict:
    from cpprcoder_tpu_torch.bench.harness import (
        CANTERBURY,
        REF_RATIOS,
        external_names,
        load,
        run_external,
    )
    from cpprcoder_tpu_torch.codecs import get_codec
    from cpprcoder_tpu_torch.codecs.pipeline import (
        pipeline_decode,
        pipeline_encode,
    )

    where = {"backend": backend, "device": device}
    files = files or CANTERBURY
    out = {"files": files, "ct": {}, "external": {}, "reference": REF_RATIOS}
    for name in ct_codecs:
        codec = get_codec(name)
        rows = {}
        for f in files:
            data = load(f)
            blob = codec.encode(data, **where)
            ok = codec.decode(blob, **where) == data
            rows[f] = {"ratio": round(len(blob) / len(data), 5),
                       "roundtrip_ok": bool(ok)}
        out["ct"][name] = rows
    for pname, stages in (pipelines or {}).items():
        rows = {}
        for f in files:
            data = load(f)
            blob = pipeline_encode(data, stages=stages, **where)
            ok = pipeline_decode(blob, **where) == data
            rows[f] = {"ratio": round(len(blob) / len(data), 5),
                       "roundtrip_ok": bool(ok)}
        out["ct"][pname] = rows
    for ext in external_names():
        agg = run_external(ext, files=files)
        out["external"][ext] = {
            r["file"]: {"ratio": round(r["ratio"], 5),
                        "enc_MBps": round(r["enc_MBps"], 1),
                        "dec_MBps": round(r["dec_MBps"], 1),
                        "roundtrip_ok": r["roundtrip_ok"]}
            for r in agg["files"]}
    return out


def to_markdown(d: dict) -> str:
    files = d["files"]
    cols = (list(d["ct"]) + [f"{e} (host)" for e in d["external"]]
            + ["ref adaptive", "ref zlib"])
    lines = ["# Ratio comparison (Canterbury corpus)", "",
             "Ratio = compressed/original (smaller is better). CT rows are "
             "the port's containers, each round-trip-verified; external "
             "rows are this host's zlib/bz2/xz; reference columns are the "
             "upstream README's published numbers (BASELINE.md).", "",
             "| File | " + " | ".join(cols) + " |",
             "|" + "---|" * (len(cols) + 1)]
    ref = d["reference"]
    for f in files:
        row = [f]
        for c in d["ct"].values():
            row.append(f'{c[f]["ratio"]:.4f}' if c[f]["roundtrip_ok"]
                       else "FAIL")
        for e in d["external"].values():
            row.append(f'{e[f]["ratio"]:.4f}')
        row.append(str(ref.get("adaptive_range", {}).get(f, "-")))
        row.append(str(ref.get("zlib", {}).get(f, "-")))
        lines.append("| " + " | ".join(row) + " |")
    lines += ["", "External host throughput (MB/s, this machine):", ""]
    lines.append("| Codec | enc MB/s (agg) | dec MB/s (agg) |")
    lines.append("|---|---|---|")
    for e, rows in d["external"].items():
        tot = sum_enc = sum_dec = 0.0
        for f in files:
            n = 1.0
            tot += n
            sum_enc += n / rows[f]["enc_MBps"]
            sum_dec += n / rows[f]["dec_MBps"]
        lines.append(f"| {e} | {tot / sum_enc:.1f} | {tot / sum_dec:.1f} |")
    return "\n".join(lines) + "\n"


def out_paths(out: str) -> tuple[Path, Path]:
    """(<out>.json, <out>.md); refuses the JAX package's COMPARISON files
    at the repository root."""
    stem = Path(out)
    paths = (stem.with_name(stem.name + ".json"),
             stem.with_name(stem.name + ".md"))
    for p in paths:
        if p.resolve() in (ROOT / "COMPARISON.json", ROOT / "COMPARISON.md"):
            raise SystemExit(f"{p} is the JAX package's comparison table; "
                             f"give --out another name")
    return paths


def main(argv=None):
    p = argparse.ArgumentParser(
        description="the port's ratio comparison table")
    p.add_argument("--out", required=True,
                   help="writes OUT.json and OUT.md")
    p.add_argument("--codecs", nargs="*", default=list(CT_DEFAULT))
    p.add_argument("--files", nargs="*", default=None)
    p.add_argument("--backend", default=None,
                   choices=["cuda", "torch", "ref"])
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; cpu when asked)")
    args = p.parse_args(argv)
    json_path, md_path = out_paths(args.out)
    d = build(ct_codecs=args.codecs, files=args.files, backend=args.backend,
              device=args.device)
    json_path.parent.mkdir(parents=True, exist_ok=True)
    json_path.write_text(json.dumps(d, indent=1))
    md_path.write_text(to_markdown(d))
    print(f"wrote {md_path} / {json_path}")


if __name__ == "__main__":
    main()
