"""Command-line interface of the port (counterpart of cpprcoder_tpu/cli.py).

    python -m cpprcoder_tpu_torch.cli compress   -c rans  in.bin out.ct
    python -m cpprcoder_tpu_torch.cli decompress -c rans  out.ct roundtrip.bin
    python -m cpprcoder_tpu_torch.cli compress   in.bin out.ct --stages blocksort mtf1 rle0 adaptive_range
    python -m cpprcoder_tpu_torch.cli decompress --stages out.ct roundtrip.bin

(--stages takes every name after it, so the files come before it.)
    python -m cpprcoder_tpu_torch.cli bench      -c adaptive_range [--files ...]
    python -m cpprcoder_tpu_torch.cli list

The codecs run on the card unless `--device cpu` (the plain PyTorch
versions) or `--backend ref` (the numpy oracle) says otherwise; with no
card and neither, the command fails with the codecs' error rather than
falling back to the CPU. `--backend native` is the host library, for
`slz4` alone. `--profile` prints the phase counters to stderr;
`--shadow` (compress) decodes each container again with an independent
backend and fails on a divergence.
"""

from __future__ import annotations

import argparse
import sys
import time

BACKENDS = ["cuda", "torch", "ref", "native"]


def _where(args) -> dict:
    return {"backend": args.backend, "device": args.device}


def main(argv=None):
    p = argparse.ArgumentParser(prog="cpprcoder_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pc = sub.add_parser("compress")
    pc.add_argument("-c", "--codec", default="rans")
    pc.add_argument("--stages", nargs="*", default=None,
                    help="pipeline stages (overrides --codec)")
    pc.add_argument("infile")
    pc.add_argument("outfile")

    pd = sub.add_parser("decompress")
    pd.add_argument("-c", "--codec", default="rans")
    pd.add_argument("--stages", action="store_true",
                    help="input is a CT-PIPE container")
    pd.add_argument("infile")
    pd.add_argument("outfile")

    pb = sub.add_parser("bench")
    pb.add_argument("-c", "--codecs", nargs="*", default=["adaptive_range"])
    pb.add_argument("--files", nargs="*", default=None)
    pb.add_argument("--json", action="store_true")

    sub.add_parser("list")

    for sp in (pc, pd, pb):
        sp.add_argument("--backend", default=None, choices=BACKENDS)
        sp.add_argument("--device", default=None,
                        help="torch device: the card by default, 'cpu' "
                             "for the plain PyTorch versions")
    for sp in (pc, pd):
        sp.add_argument("--profile", action="store_true",
                        help="print per-phase counters to stderr")
    # shadow verification hooks Codec.encode only, so the flag belongs to
    # compress alone (on decompress it would be a silent no-op)
    pc.add_argument("--shadow", action="store_true",
                    help="verify encode with an independent shadow "
                         "decode (divergence detection)")

    args = p.parse_args(argv)

    if args.cmd == "list":
        from cpprcoder_tpu_torch.codecs import list_codecs

        print("\n".join(list_codecs()))
        return 0

    if args.cmd == "bench":
        from cpprcoder_tpu_torch.bench import harness

        harness.main((args.codecs or [])
                     + (["--json"] if args.json else [])
                     + (["--files"] + args.files if args.files else [])
                     + (["--backend", args.backend] if args.backend else [])
                     + (["--device", args.device] if args.device else []))
        return 0

    from cpprcoder_tpu_torch import debug
    from cpprcoder_tpu_torch.utils import profiling

    with open(args.infile, "rb") as f:
        data = f.read()
    # the switches are the process's; a caller of main() gets its own back
    was = debug.shadow_enabled(), profiling.enabled()
    if args.profile:
        profiling.enable()
    if getattr(args, "shadow", False):
        debug.set_shadow(True)
    try:
        t0 = time.perf_counter()
        if args.cmd == "compress":
            if args.stages:
                from cpprcoder_tpu_torch.codecs.pipeline import (
                    pipeline_encode,
                )

                out = pipeline_encode(data, stages=args.stages,
                                      **_where(args))
            else:
                from cpprcoder_tpu_torch.codecs import compress

                out = compress(data, codec=args.codec, **_where(args))
            msg = (f"{len(data)} -> {len(out)} "
                   f"({len(out)/max(len(data),1):.4f})")
        else:
            if args.stages:
                from cpprcoder_tpu_torch.codecs.pipeline import (
                    pipeline_decode,
                )

                out = pipeline_decode(data, **_where(args))
            else:
                from cpprcoder_tpu_torch.codecs import decompress

                out = decompress(data, codec=args.codec, **_where(args))
            msg = f"{len(data)} -> {len(out)}"
        with open(args.outfile, "wb") as f:
            f.write(out)
        print(f"{msg} in {time.perf_counter()-t0:.2f}s", file=sys.stderr)
        if args.profile:
            print(profiling.format_report(), file=sys.stderr)
    finally:
        debug.set_shadow(was[0])
        if not was[1]:
            profiling.disable()
    return 0


if __name__ == "__main__":
    sys.exit(main())
