"""Convert checkpoints of the original PyTorch TecoGAN (``generator.pt``,
``discrim.pt``) and torchvision VGG-19 state dicts to ``.ckpt`` files, and
``.ckpt`` files back to reference-loadable ``.pt`` files.

    python -m tecogan_tpu_torch.tools.convert_torch_ckpt --torch generator.pt \\
        --arch generator --out generator.ckpt [--num_resblock 16]
    python -m tecogan_tpu_torch.tools.convert_torch_ckpt --torch vgg19.pth \\
        --arch vgg19 --out vgg.ckpt
    python -m tecogan_tpu_torch.tools.convert_torch_ckpt --reverse generator.ckpt \\
        --arch generator --out generator.pt

The same command line as the JAX package's ``tools/convert_torch_ckpt.py``,
writing the same files.  The port's modules hold the reference's tensors
in the reference's layout (``Conv2d`` OIHW, ``ConvTranspose2d`` ``(I, O,
kh, kw)`` unflipped, ``Linear`` ``(out, in)``), so a reference state dict
maps onto the port's ``state_dict`` by renaming alone (the tables below,
after the reference's ``ModuleList`` / ``Sequential`` order,
code/models.py:54-146); ``utils.convert`` then writes the flax layout
every ``.ckpt`` holds.  BatchNorm's ``weight`` is the port's ``scale``,
and its running ``mean`` / ``var`` go to ``batch_stats``.

The input is read with ``torch.load(..., weights_only=False)``, as the JAX
tool reads it: the reference saved whole dicts with an ``epoch``, so a
weights-only load could refuse them.  That unpickles the file: convert
only checkpoints from a source you trust.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Mapping, Tuple

import torch

from ..utils.checkpoint import load_flat, save_pytree, unflatten
from ..utils.convert import (discriminator_params_to_jax,
                             discriminator_state_dict_from_jax,
                             generator_params_to_jax, generator_state_dict_from_jax,
                             vgg_params_to_jax)

# (port module, reference module, kind): "conv" carries a bias when the
# reference has one, "conv_nb" never does (the reference's residual
# blocks, Sequential(conv, ReLU, conv-nobias)), "bn" is a BatchNorm2d
Table = List[Tuple[str, str, str]]

_VGG_TORCHVISION_IDX = [  # torchvision vgg19.features conv indices, in order
    0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30, 32, 34,
]
_VGG_NAMES = [
    "conv1_1", "conv1_2", "conv2_1", "conv2_2",
    "conv3_1", "conv3_2", "conv3_3", "conv3_4",
    "conv4_1", "conv4_2", "conv4_3", "conv4_4",
    "conv5_1", "conv5_2", "conv5_3", "conv5_4",
]
_BN = (("weight", "scale"), ("bias", "bias"))
_BN_STATS = (("running_mean", "mean"), ("running_var", "var"))


def _resblock(port: str, ref: str) -> Table:
    return [(f"{port}.Conv_0", f"{ref}.0", "conv"), (f"{port}.Conv_1", f"{ref}.2", "conv_nb")]


def generator_table(num_resblock: int = 16) -> Table:
    """The generator (code/models.py:61-86).  ``conv_trans`` is
    Sequential(0 convT, 1 ReLU, 2 resblock, 3 resblock, 4 convT, 5 ReLU,
    6 conv, 7 ReLU)."""
    t: Table = [("conv_in", "conv.0", "conv")]
    for i in range(num_resblock):
        t += _resblock(f"resblock_{i}", f"resids.{i}")
    return t + ([("up1", "conv_trans.0", "conv")] + _resblock("trunk_rb1", "conv_trans.2")
                + _resblock("trunk_rb2", "conv_trans.3")
                + [("up2", "conv_trans.4", "conv"), ("conv_hr", "conv_trans.6", "conv"),
                   ("conv_out", "output", "conv")])


def discriminator_table(resblocks: int = 4) -> Table:
    """The discriminator (code/models.py:97-146): each block a
    Sequential(conv-nobias, BN, ...), each residual group a list of
    Sequential(residual_block, BN)."""
    t: Table = [("conv_in", "conv.0", "conv")]

    def block(k):
        return [(f"block{k}.Conv_0", f"block{k}.0", "conv_nb"),
                (f"block{k}.BatchNorm_0", f"block{k}.1", "bn")]

    for k in (1, 2, 3):
        t += block(k)
        for i in range(resblocks):
            t += _resblock(f"resids{k}.rb_{i}", f"resids{k}.{i}.0")
            t.append((f"resids{k}.bn_{i}", f"resids{k}.{i}.1", "bn"))
    return t + block(4) + block(5) + [("fc", "fc", "conv")]


def vgg19_table(sd: Mapping[str, torch.Tensor]) -> Table:
    """torchvision's ``vgg19.features`` conv indices (``features.N``, or
    a bare ``N`` where the dict has no ``features.`` prefix)."""
    return [(name, f"features.{idx}" if f"features.{idx}.weight" in sd else str(idx), "conv")
            for idx, name in zip(_VGG_TORCHVISION_IDX, _VGG_NAMES)]


def from_reference(sd: Mapping[str, torch.Tensor], table: Table
                   ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """A reference state dict -> (the port's ``state_dict``, its BatchNorm
    running statistics keyed ``<bn>.mean`` / ``.var``), float32 copies."""
    params: Dict[str, torch.Tensor] = {}
    stats: Dict[str, torch.Tensor] = {}

    def take(src):
        return sd[src].detach().to(torch.float32, copy=True).contiguous()

    for port, ref, kind in table:
        if kind == "bn":
            for a, b in _BN:
                params[f"{port}.{b}"] = take(f"{ref}.{a}")
            for a, b in _BN_STATS:
                stats[f"{port}.{b}"] = take(f"{ref}.{a}")
            continue
        params[f"{port}.weight"] = take(f"{ref}.weight")
        if kind == "conv" and f"{ref}.bias" in sd:
            params[f"{port}.bias"] = take(f"{ref}.bias")
    return params, stats


def to_reference(params: Mapping[str, torch.Tensor], stats: Mapping[str, torch.Tensor],
                 table: Table) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`from_reference`: the reference's state dict
    (float32 CPU tensors), BN running statistics included."""
    sd: Dict[str, torch.Tensor] = {}

    def put(dst, t):
        sd[dst] = t.detach().to("cpu", torch.float32, copy=True).contiguous()

    for port, ref, kind in table:
        if kind == "bn":
            for a, b in _BN:
                put(f"{ref}.{a}", params[f"{port}.{b}"])
            for a, b in _BN_STATS:
                put(f"{ref}.{a}", stats[f"{port}.{b}"])
            continue
        put(f"{ref}.weight", params[f"{port}.weight"])
        if f"{port}.bias" in params:
            put(f"{ref}.bias", params[f"{port}.bias"])
    return sd


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--torch", help="input .pt/.pth file (forward direction)")
    ap.add_argument("--arch", required=True,
                    choices=["generator", "discriminator", "vgg19"])
    ap.add_argument("--out", required=True)
    ap.add_argument("--num_resblock", type=int, default=16)
    ap.add_argument("--discrim_resblocks", type=int, default=4)
    ap.add_argument("--reverse", metavar="CKPT",
                    help="export a .ckpt to a reference-loadable torch .pt instead")
    args = ap.parse_args(argv)

    if args.reverse:
        if args.arch == "vgg19":
            ap.error("--reverse supports generator/discriminator")
        flat, meta = load_flat(args.reverse)
        tree = unflatten(flat)
        params = tree.get("model_state_dict", tree)
        if args.arch == "generator":
            sd = to_reference(generator_state_dict_from_jax(params), {},
                              generator_table(args.num_resblock))
            torch.save({"epoch": int(meta.get("epoch", 0)), "model_state_dict": sd}, args.out)
        else:
            p, s = discriminator_state_dict_from_jax(params, tree.get("batch_stats", {}))
            sd = to_reference(p, s, discriminator_table(args.discrim_resblocks))
            torch.save({"model_state_dict": sd}, args.out)
        print(f"wrote {args.out} (torch)")
        return

    if not args.torch:
        ap.error("--torch is required (or use --reverse)")
    raw = torch.load(args.torch, map_location="cpu", weights_only=False)
    sd = raw.get("model_state_dict", raw) if isinstance(raw, dict) else raw
    epoch = raw.get("epoch", 0) if isinstance(raw, dict) else 0

    if args.arch == "generator":
        params, _ = from_reference(sd, generator_table(args.num_resblock))
        save_pytree(args.out, {"model_state_dict": generator_params_to_jax(params)},
                    meta={"epoch": epoch})
    elif args.arch == "discriminator":
        params, stats = from_reference(sd, discriminator_table(args.discrim_resblocks))
        p, s = discriminator_params_to_jax(params, stats)
        save_pytree(args.out, {"model_state_dict": p, "batch_stats": s})
    else:
        params, _ = from_reference(sd, vgg19_table(sd))
        save_pytree(args.out, {"model_state_dict": vgg_params_to_jax(params)})
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
