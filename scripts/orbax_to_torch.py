"""Carry an Orbax checkpoint of the JAX package into the PyTorch port's
checkpoint format.

    python scripts/orbax_to_torch.py <orbax_dir> <out.pt> [--config cfg.json]

``orbax_dir`` is a directory written by the JAX package's
``training.checkpoint.save_model`` (``best_epoch_<e>`` or ``last_epoch``:
``{epoch, params, batch_stats, opt_state}``). The script restores it with
``bevrender_tpu.training.checkpoint.restore_model`` on the CPU, converts
the weights with the port's ``convert.flax_to_state_dict``, or, where the
checkpoint holds an optimizer state, the weights and AdamW's moments and
count with ``convert.train_state_to_torch``, loads both into the port's
model and AdamW (strict: every name and shape must match ``--config``'s
model, by default ``Config()``'s), and writes ``{epoch, model, optimizer,
step}`` to ``out.pt`` through the port's ``training.checkpoint``.
``RegistrationPipeline.from_checkpoint`` serves the file and
``Trainer.restore_checkpoint`` resumes from it.

The port imports no JAX, flax or Orbax: this bridge runs where the JAX
package is installed, and is no module of the port.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _adam_state(tree):
    """The ``{count, mu, nu}`` of optax's ``scale_by_adam`` inside a
    restored optimizer state (nested dicts and lists), or None."""
    if isinstance(tree, dict):
        if "mu" in tree and "nu" in tree:
            return tree
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for child in tree:
            found = _adam_state(child)
            if found is not None:
                return found
    return None


def convert(orbax_dir: str, out: str, config=None) -> str:
    """Restore ``orbax_dir``, convert it and write ``out``; returns its
    path. ``config`` is a port ``Config`` (default ``Config()``)."""
    import jax
    import numpy as np

    from bevrender_tpu.training.checkpoint import restore_model
    from bevrender_tpu_torch.config import Config
    from bevrender_tpu_torch.convert import (
        flax_to_state_dict,
        load_adamw_state,
        train_state_to_torch,
    )
    from bevrender_tpu_torch.models.bevrender import BEVRenderNet
    from bevrender_tpu_torch.training.checkpoint import write_model
    from bevrender_tpu_torch.training.trainer import adamw

    config = config or Config()
    restored = jax.tree_util.tree_map(np.asarray,
                                      restore_model(str(orbax_dir)))
    params = restored["params"]
    batch_stats = restored.get("batch_stats") or {}
    adam = _adam_state(restored.get("opt_state"))
    net = BEVRenderNet(config.model)
    optimizer = adamw(net, config.train)
    if adam is None:
        net.load_state_dict(flax_to_state_dict(
            {"params": params, "batch_stats": batch_stats}), strict=True)
        step = 0
    else:
        state_dict, moments = train_state_to_torch(
            params, batch_stats,
            {"mu": adam["mu"], "nu": adam["nu"], "count": adam["count"]})
        net.load_state_dict(state_dict, strict=True)
        load_adamw_state(optimizer, net, moments)
        step = moments["step"]
    return write_model(out, {"model": net.state_dict(),
                             "optimizer": optimizer.state_dict(),
                             "step": step},
                       int(np.asarray(restored.get("epoch", 0))))


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("orbax_dir", help="a checkpoint directory of the JAX "
                                      "package's save_model")
    ap.add_argument("out", help="the port's checkpoint file to write")
    ap.add_argument("--config", help="JSON config (Config.to_json of either "
                                     "package) of the checkpoint's model")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import jax

    jax.config.update("jax_platforms", "cpu")
    from bevrender_tpu_torch.config import Config

    config = (Config.from_json(Path(args.config).read_text())
              if args.config else None)
    path = convert(args.orbax_dir, args.out, config)
    print(path)
    return path


if __name__ == "__main__":
    main()
