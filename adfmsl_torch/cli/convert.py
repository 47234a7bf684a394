"""Wav2Vec2 export CLI of the port: a local HF torch Wav2Vec2 checkpoint ->
adfmsl's native ``.msgpack`` param tree.

    python -m adfmsl_torch.cli.convert --torch_ckpt pytorch_model.bin \\
        --arch base|large|tiny --out W.msgpack [--verify] [--device cuda|cpu]

Port of ``adfmsl/cli/convert.py`` (zero-egress analog of the reference's hub
download at model construction, maze2.py:89-90): ``models/w2v2.py``'s
``port_hf_state_dict`` builds adfmsl's flax tree of the encoder and
``save_native`` writes it, byte for byte the file adfmsl's CLI writes.
``--verify`` loads the file back and compares the encoder's forward on the
seeded (1, 3200) input with the converted tree's (rc 1 above 1e-6), on the
card unless ``--device cpu`` is given. ``wav2vec2.pretrained_path`` takes the
file (``models/pretrained.py``).
"""
from __future__ import annotations

import argparse
import sys


def build_parser():
    p = argparse.ArgumentParser("adfmsl_torch.cli.convert")
    p.add_argument("--torch_ckpt", required=True,
                   help="local pytorch_model.bin / .pt / .safetensors")
    p.add_argument("--arch", default="base", choices=["base", "large", "tiny"])
    p.add_argument("--out", required=True, help="output .msgpack path")
    p.add_argument("--verify", action="store_true",
                   help="round-trip load and compare a forward pass")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu': where --verify runs")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from adfmsl_torch.models.pretrained import save_native
    from adfmsl_torch.models.w2v2 import W2V2Arch, port_hf_state_dict, read_hf_state_dict

    arch = {"base": W2V2Arch.base(), "large": W2V2Arch.large_960h(),
            "tiny": W2V2Arch.tiny()}[args.arch]
    params = port_hf_state_dict(read_hf_state_dict(args.torch_ckpt), arch)
    save_native(params, args.out)
    print(f"converted {args.torch_ckpt} -> {args.out}")

    if args.verify:
        import numpy as np
        import torch

        from adfmsl_torch.device import resolve_device
        from adfmsl_torch.models.port import flax_tree_to_state_dict
        from adfmsl_torch.models.pretrained import load_native
        from adfmsl_torch.models.w2v2 import Wav2Vec2Encoder

        dev = resolve_device(args.device)
        back = load_native(args.out, params)
        enc = Wav2Vec2Encoder(arch=arch, normalize_input=False).to(dev).eval()
        x = torch.from_numpy(np.random.default_rng(0)
                             .standard_normal((1, 3200)).astype(np.float32)).to(dev)
        outs = []
        for tree in (params, back):
            enc.load_state_dict(flax_tree_to_state_dict(tree), strict=True)
            with torch.inference_mode():
                outs.append(enc(x))
        err = float((outs[0] - outs[1]).abs().max())
        print(f"round-trip max abs err: {err:.2e}")
        return 0 if err < 1e-6 else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
