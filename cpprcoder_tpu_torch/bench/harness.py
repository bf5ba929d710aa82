"""Canterbury benchmark and verification harness of the port (counterpart
of cpprcoder_tpu/bench/harness.py, with the same surface and corpus
tables).

For each file: encode, decode, byte-compare, and report the ratio and the
throughput on the host clock (each call ends in bytes on the host, so it
waits for the card), as a Markdown table or JSON. `run_codec` and `main`
take `backend` and `device` as the codecs do (the card by default; "cpu"
only when asked for). The stdlib compressors (zlib, bzip2, xz) give the
comparison rows. Silesia is optional: its files are not in the
repository, and rows appear only for those found locally.

    python -m cpprcoder_tpu_torch.bench.harness rcx rans --device cpu
"""

from __future__ import annotations

import json
import os
import time


CANTERBURY = [
    "alice29.txt", "asyoulik.txt", "cp.html", "fields.c", "grammar.lsp",
    "kennedy.xls", "lcet10.txt", "plrabn12.txt", "ptt5", "sum", "xargs.1",
]

# reference ratios (BASELINE.md; compressed/original, smaller = better)
REF_RATIOS = {
    "static_range": {
        "alice29.txt": 0.574532, "asyoulik.txt": 0.605293, "cp.html": 0.674836,
        "fields.c": 0.672646, "grammar.lsp": 0.718893, "kennedy.xls": 0.452938,
        "lcet10.txt": 0.585129, "plrabn12.txt": 0.567788, "ptt5": 0.157010,
        "sum": 0.679759, "xargs.1": 0.735510,
    },
    "adaptive_range": {
        "alice29.txt": 0.573000, "asyoulik.txt": 0.603400, "cp.html": 0.662480,
        "fields.c": 0.642511, "grammar.lsp": 0.619457, "kennedy.xls": 0.447426,
        "lcet10.txt": 0.584625, "plrabn12.txt": 0.567367, "ptt5": 0.152158,
        "sum": 0.670450, "xargs.1": 0.648924,
    },
    "slz4": {
        "alice29.txt": 0.590510, "asyoulik.txt": 0.623499, "cp.html": 0.494452,
        "fields.c": 0.479283, "grammar.lsp": 0.527546, "kennedy.xls": 0.362974,
        "lcet10.txt": 0.552485, "plrabn12.txt": 0.654747, "sum": 0.501464,
        "xargs.1": 0.637568,
    },
}


def data_dir() -> str:
    return os.path.join(os.path.dirname(__file__), "..", "..", "data")


# The 12 Silesia paths the reference names (test/main.cpp:1259-1270). The
# corpus is not redistributable inside this repo; point CT_SILESIA_DIR at
# an extracted copy (http://sun.aei.polsl.pl/~sdeor/corpus/silesia.zip) or
# drop the files in data/silesia/. Rows appear only for present files.
SILESIA = ["dickens", "mozilla", "mr", "nci", "ooffice", "osdb", "reymont",
           "samba", "sao", "webster", "xml", "x-ray"]


def silesia_files() -> list[str]:
    """Silesia corpus file PATHS that exist locally (may be empty)."""
    root = os.environ.get(
        "CT_SILESIA_DIR", os.path.join(data_dir(), "silesia"))
    return [os.path.join(root, f) for f in SILESIA
            if os.path.exists(os.path.join(root, f))]


def load(name: str) -> bytes:
    path = name if os.path.isabs(name) else os.path.join(data_dir(), name)
    with open(path, "rb") as f:
        return f.read()


def run_codec(codec_name: str, files=None, repeats: int = 3,
              warmup: bool = True, backend: str | None = None, device=None,
              **opts) -> dict:
    """Encode and decode each corpus file on `backend`/`device`; verify;
    time the best of `repeats` (after a warm-up call that builds the
    kernels)."""
    from cpprcoder_tpu_torch.codecs import get_codec

    codec = get_codec(codec_name)
    where = {"backend": backend, "device": device}
    files = files or CANTERBURY
    rows = []
    for name in files:
        data = load(name)
        if warmup:
            blob = codec.encode(data, **where, **opts)
            out = codec.decode(blob, **where)
        enc_t = dec_t = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            blob = codec.encode(data, **where, **opts)
            enc_t = min(enc_t, time.perf_counter() - t0)
            t0 = time.perf_counter()
            out = codec.decode(blob, **where)
            dec_t = min(dec_t, time.perf_counter() - t0)
        ok = out == data
        rows.append({
            "file": os.path.basename(name), "bytes": len(data),
            "compressed": len(blob),
            "ratio": len(blob) / len(data),
            "enc_MBps": len(data) / enc_t / 1e6,
            "dec_MBps": len(data) / dec_t / 1e6,
            "roundtrip_ok": bool(ok),
            "ref_ratio": REF_RATIOS.get(codec_name, {}).get(
                os.path.basename(name)),
        })
    total = sum(r["bytes"] for r in rows)
    comp = sum(r["compressed"] for r in rows)
    agg = {
        "codec": codec_name,
        "files": rows,
        "total_bytes": total,
        "weighted_ratio": comp / total,
        "enc_MBps_agg": total / sum(r["bytes"] / r["enc_MBps"] for r in rows),
        "dec_MBps_agg": total / sum(r["bytes"] / r["dec_MBps"] for r in rows),
        "all_roundtrip_ok": all(r["roundtrip_ok"] for r in rows),
    }
    return agg


_EXTERNAL = {}


def _register_external():
    """Host baseline compressors for comparison rows (the reference harness
    cross-checks zlib/LZ4/zstd, test/main.cpp:130-251): zlib, bzip2 and xz
    from the standard library, lz4 and zstd where their packages are
    installed (absent ones are skipped)."""
    if _EXTERNAL:
        return
    import zlib

    _EXTERNAL["zlib"] = (lambda d: zlib.compress(d, 6), zlib.decompress)
    try:
        import bz2

        _EXTERNAL["bzip2"] = (lambda d: bz2.compress(d, 9), bz2.decompress)
    except ImportError:
        pass
    try:
        import lzma

        _EXTERNAL["xz"] = (
            lambda d: lzma.compress(d, preset=6), lzma.decompress)
    except ImportError:
        pass
    try:
        import lz4.block as lz4b

        _EXTERNAL["lz4"] = (
            lambda d: lz4b.compress(d, store_size=True), lz4b.decompress)
    except ImportError:
        pass
    try:
        import zstandard as zstd

        _EXTERNAL["zstd"] = (
            lambda d: zstd.ZstdCompressor().compress(d),
            lambda b: zstd.ZstdDecompressor().decompress(b))
    except ImportError:
        pass


def external_names() -> list[str]:
    _register_external()
    return sorted(_EXTERNAL)


def run_external(name: str, files=None, repeats: int = 3) -> dict:
    """Baseline comparison rows, same shape as run_codec output."""
    _register_external()
    enc, dec = _EXTERNAL[name]
    files = files or CANTERBURY
    rows = []
    for fname in files:
        data = load(fname)
        enc_t = dec_t = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            blob = enc(data)
            enc_t = min(enc_t, time.perf_counter() - t0)
            t0 = time.perf_counter()
            out = dec(blob)
            dec_t = min(dec_t, time.perf_counter() - t0)
        rows.append({
            "file": fname, "bytes": len(data), "compressed": len(blob),
            "ratio": len(blob) / len(data),
            "enc_MBps": len(data) / enc_t / 1e6,
            "dec_MBps": len(data) / dec_t / 1e6,
            "roundtrip_ok": bool(out == data),
            "ref_ratio": None,
        })
    total = sum(r["bytes"] for r in rows)
    return {
        "codec": name,
        "files": rows,
        "total_bytes": total,
        "weighted_ratio": sum(r["compressed"] for r in rows) / total,
        "enc_MBps_agg": total / sum(r["bytes"] / r["enc_MBps"] for r in rows),
        "dec_MBps_agg": total / sum(r["bytes"] / r["dec_MBps"] for r in rows),
        "all_roundtrip_ok": all(r["roundtrip_ok"] for r in rows),
    }


def markdown_table(agg: dict) -> str:
    lines = [f"### {agg['codec']}",
             "| file | ratio | ref ratio | enc MB/s | dec MB/s | ok |",
             "|---|---|---|---|---|---|"]
    for r in agg["files"]:
        ref = f"{r['ref_ratio']:.4f}" if r["ref_ratio"] else "-"
        lines.append(
            f"| {r['file']} | {r['ratio']:.4f} | {ref} | "
            f"{r['enc_MBps']:.1f} | {r['dec_MBps']:.1f} | "
            f"{'Y' if r['roundtrip_ok'] else 'FAIL'} |")
    lines.append(
        f"| **total** | **{agg['weighted_ratio']:.4f}** |  | "
        f"**{agg['enc_MBps_agg']:.1f}** | **{agg['dec_MBps_agg']:.1f}** | "
        f"{'Y' if agg['all_roundtrip_ok'] else 'FAIL'} |")
    return "\n".join(lines)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        description="cpprcoder_tpu_torch corpus benchmark")
    p.add_argument("codecs", nargs="*", default=["static_range"],
                   help="codec names (see list_codecs())")
    p.add_argument("--json", action="store_true")
    p.add_argument("--files", nargs="*", default=None)
    p.add_argument("--backend", default=None,
                   choices=["cuda", "torch", "ref", "native"])
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; cpu when asked)")
    p.add_argument("--corpus", choices=["canterbury", "silesia"],
                   default="canterbury",
                   help="silesia needs CT_SILESIA_DIR or data/silesia/")
    args = p.parse_args(argv)
    if args.corpus == "silesia" and args.files is None:
        args.files = silesia_files()
        if not args.files:
            print(json.dumps({"error": "silesia corpus not present",
                              "hint": "set CT_SILESIA_DIR or extract "
                                      "silesia.zip into data/silesia/"}))
            return
    for name in args.codecs:
        if name in external_names():
            agg = run_external(name, files=args.files)
        else:
            agg = run_codec(name, files=args.files, backend=args.backend,
                            device=args.device)
        if args.json:
            print(json.dumps(agg))
        else:
            print(markdown_table(agg))


if __name__ == "__main__":
    main()
