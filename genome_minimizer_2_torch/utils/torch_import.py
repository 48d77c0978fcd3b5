"""Import reference torch checkpoints (.pt state_dicts): the port's copy of
the JAX package's ``utils/torch_import.py``.

A user of the reference has ``saved_VAE_{v0..v3}.pt`` files written by
``torch.save(model.state_dict())``. This module converts one into the
config-bearing ``.npz`` checkpoint that both packages load
(``utils/checkpoint.py``); the cached ``<file>.pt.npz`` sibling holds the
same arrays and the same JSON as the JAX package's, so either package reuses
the other's cache. It is the second route by which weights are carried
across, beside ``models/vae.py::params_from_flat``.

Key mapping (the reference's model layout):
  encoder.{0,3,6}.{weight,bias}      -> params/encoder/{i}/{w.T, b}
  encoder.{1,4,7}.{weight,bias}      -> params/encoder/{i}/bn/{scale,bias}
  encoder.{1,4,7}.running_{mean,var} -> batch_stats/encoder/{i}/{mean,var}
  mean_layer / logvar_layer          -> params/{mean,logvar}
  decoder.{0,3,6}.* / decoder.9.*    -> params/decoder/{0..3} analogously

Weights transpose from torch's (out, in) to the (in, out) layout; the gene
axis zero-pads to the model's padded_dim. The port is torch, so the
``.pt`` is read in-process (the JAX package converts in a subprocess).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict

import numpy as np


def _pad2(w: np.ndarray, rows: int, cols: int) -> np.ndarray:
    out = np.zeros((rows, cols), np.float32)
    out[: w.shape[0], : w.shape[1]] = w
    return out


def _pad1(b: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros(n, np.float32)
    out[: b.shape[0]] = b
    return out


def convert_state_dict(
    state_dict: Dict[str, np.ndarray],
    pad_features: bool = True,
) -> tuple[Dict[str, np.ndarray], dict]:
    """torch state_dict (tensors or ndarrays) -> flat {path: array} in the
    checkpoint layout. Returns (flat_arrays, inferred_dims)."""
    sd = {k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v,
                        np.float32)
          for k, v in state_dict.items()}
    input_dim, hidden_dim = sd["encoder.0.weight"].shape[1], sd["encoder.0.weight"].shape[0]
    latent_dim = sd["mean_layer.weight"].shape[0]
    padded = ((input_dim + 127) // 128 * 128) if pad_features else input_dim

    flat: Dict[str, np.ndarray] = {}

    def linear(prefix_t, prefix_o, rows, cols):
        flat[f"params/{prefix_o}/w"] = _pad2(sd[f"{prefix_t}.weight"].T, rows, cols)
        flat[f"params/{prefix_o}/b"] = _pad1(sd[f"{prefix_t}.bias"], cols)

    def bn(prefix_t, tree, idx):
        flat[f"params/{tree}/{idx}/bn/scale"] = sd[f"{prefix_t}.weight"]
        flat[f"params/{tree}/{idx}/bn/bias"] = sd[f"{prefix_t}.bias"]
        flat[f"batch_stats/{tree}/{idx}/mean"] = sd[f"{prefix_t}.running_mean"]
        flat[f"batch_stats/{tree}/{idx}/var"] = sd[f"{prefix_t}.running_var"]

    linear("encoder.0", "encoder/0", padded, hidden_dim)
    bn("encoder.1", "encoder", 0)
    linear("encoder.3", "encoder/1", hidden_dim, hidden_dim)
    bn("encoder.4", "encoder", 1)
    linear("encoder.6", "encoder/2", hidden_dim, hidden_dim)
    bn("encoder.7", "encoder", 2)
    linear("mean_layer", "mean", hidden_dim, latent_dim)
    linear("logvar_layer", "logvar", hidden_dim, latent_dim)
    linear("decoder.0", "decoder/0", latent_dim, hidden_dim)
    bn("decoder.1", "decoder", 0)
    linear("decoder.3", "decoder/1", hidden_dim, hidden_dim)
    bn("decoder.4", "decoder", 1)
    linear("decoder.6", "decoder/2", hidden_dim, hidden_dim)
    bn("decoder.7", "decoder", 2)
    linear("decoder.9", "decoder/3", hidden_dim, padded)

    dims = dict(input_dim=input_dim, hidden_dim=hidden_dim,
                latent_dim=latent_dim, padded_dim=padded)
    return flat, dims


def write_npz(flat: Dict[str, np.ndarray], dims: dict, config_overrides: dict,
              out_path: str) -> None:
    """Write the checkpoint .npz (the format of utils.checkpoint)."""
    config = {
        "hidden_dim": dims["hidden_dim"], "latent_dim": dims["latent_dim"],
        "pad_features": dims["padded_dim"] != dims["input_dim"],
    }
    config.update(config_overrides)
    meta = {"config": config,
            "extra": {"input_dim": dims["input_dim"],
                      "imported_from": "torch_state_dict"}}
    arrays = dict(flat)
    arrays["__config_json__"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    np.savez(out_path, **arrays)


def convert_file(pt_path: str, out_path: str, trainer_version: str = "v0",
                 pad_features: bool = True) -> dict:
    """Load a .pt state_dict (tensors only) and write the .npz."""
    import torch

    sd = torch.load(pt_path, map_location="cpu", weights_only=True)
    flat, dims = convert_state_dict(sd, pad_features)
    write_npz(flat, dims, {"trainer_version": trainer_version}, out_path)
    return dims


def infer_version_from_filename(path) -> str | None:
    """The reference's filename-based preset inference ('v0' in the name
    etc.)."""
    name = Path(path).name.lower()
    for v in ("v0", "v1", "v2", "v3"):
        if v in name:
            return v
    return None


def ensure_npz(model_path: str, trainer_version: str | None = None) -> str:
    """Accept a framework ``.npz`` checkpoint or a reference torch
    ``.pt``/``.pth`` state_dict. A torch file is converted to a cached
    ``<file>.pt.npz`` sibling (reused unless the .pt is newer) and that path
    is returned; other paths pass through."""
    p = Path(model_path)
    if p.suffix.lower() not in (".pt", ".pth"):
        return model_path
    out = p.with_name(p.name + ".npz")
    if out.exists() and out.stat().st_mtime >= p.stat().st_mtime:
        return str(out)
    version = trainer_version or infer_version_from_filename(p)
    if version is None:
        raise ValueError(
            f"Could not detect version (v0..v3) from filename: {p.name}; "
            "pass trainer_version explicitly or rename the checkpoint")
    convert_file(str(p), str(out), trainer_version=version)
    return str(out)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Convert a reference saved_VAE_*.pt into a framework .npz")
    parser.add_argument("pt_path")
    parser.add_argument("out_path")
    parser.add_argument("--trainer-version", default="v0",
                        choices=["v0", "v1", "v2", "v3"])
    parser.add_argument("--no-pad-features", action="store_false",
                        dest="pad_features")
    args = parser.parse_args(argv)
    dims = convert_file(args.pt_path, args.out_path, args.trainer_version,
                        args.pad_features)
    print(f"✓ Converted {args.pt_path} -> {args.out_path} ({dims})")


if __name__ == "__main__":
    main()
