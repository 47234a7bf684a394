"""Pack CLI of the port (port of ``adfmsl/cli/pack.py``): one-time corpus
preprocessing into a mmap'd packed array.

    python -m adfmsl_torch.cli.pack --protocol P --data_dir D --out_prefix OUT \\
        [--cut 64600 --pad_mode tile|zero --num_workers 4 --polarity bonafide1]

Decodes and pads the whole protocol once (the native decoder, ``num_workers``
threads) into ``OUT.npy`` + ``OUT.json``; training and evaluation epochs then
stream fixed-shape clips with no decode through ``PackedDataset``
(``cli.train --train_pack / --dev_pack / --eval_pack``, ``cli.evaluate
--pack``). The format is adfmsl's, so either package reads the other's packs.
Runs on the host alone.
"""
from __future__ import annotations

import argparse
import logging
import sys
import time


def build_parser():
    p = argparse.ArgumentParser("adfmsl_torch.cli.pack")
    p.add_argument("--protocol", required=True)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--out_prefix", required=True,
                   help="writes {prefix}.npy + {prefix}.json")
    p.add_argument("--cut", type=int, default=64600)
    p.add_argument("--pad_mode", default="tile", choices=["tile", "zero"])
    p.add_argument("--sample_rate", type=int, default=16000)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--polarity", default="bonafide1",
                   choices=["bonafide1", "spoof1"])
    return p


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)

    from adfmsl_torch.data import create_pack, parse_protocol

    proto = parse_protocol(args.protocol, args.polarity)
    t0 = time.perf_counter()
    npy, _ = create_pack(proto, args.data_dir, args.out_prefix, cut=args.cut,
                         pad_mode=args.pad_mode, sample_rate=args.sample_rate,
                         num_workers=args.num_workers)
    dt = time.perf_counter() - t0
    print(f"packed {len(proto)} utterances -> {npy} "
          f"({len(proto) / max(dt, 1e-9):.0f} utt/s decode)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
