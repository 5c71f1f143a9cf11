"""End-to-end training driver.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --steps 100 --batch 8 --seq 256 --ckpt-dir <dir> [--device cpu]

Port of ``repro.launch.train``: a real training loop (default: the smoke
config of the arch; ``--full`` trains ``get_arch(arch)`` at full width on
the one card), with the deterministic resumable data pipeline, the
microbatched step, async checkpoints, restart-on-failure (``--fail-at``)
and straggler accounting.  Runs on the GPU unless ``--device cpu``, and
raises without a card.  As in the reference, the run takes a mesh (the
``(n_devices, 1)`` data-parallel mesh of its one device; ``--full``: the
production 16x16 mesh), the params' shardings on it and
``shardctx.use_mesh``, under which the attention picks the reference's
GQA form; the port places nothing (one card holds every tensor whole).
``remat`` has no counterpart (``models/transformer.py``): llama3.2-1b
trains without it on one 80 GB card.

``main`` returns the :class:`Trainer`, so a caller can read the final
state.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from repro_torch.configs import get_arch, smoke_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.distributed import sharding, shardctx
from repro_torch.distributed.sharding import NamedMesh
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model_zoo
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import tree as tree_lib
from repro_torch.train.optimizer import AdamW
from repro_torch.train.trainer import Trainer, TrainState, make_train_step


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--full", action="store_true",
                    help="the arch's full config on the one card")
    ap.add_argument("--d-model", type=int, default=None,
                    help="override smoke width (e.g. ~100M model)")
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure at this step (restart demo)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    if args.full:
        cfg = get_arch(args.arch)
        mesh = make_production_mesh()
    else:
        over = {}
        if args.d_model:
            over.update(d_model=args.d_model,
                        head_dim=max(args.d_model // 8, 16), n_heads=8,
                        n_kv_heads=4,
                        d_ff=0 if get_arch(args.arch).d_ff == 0
                        else args.d_model * 4,
                        vocab_size=8192)
        if args.n_layers:
            period = get_arch(args.arch).layer_period
            over["n_layers"] = max(period, args.n_layers // period * period)
        cfg = smoke_config(args.arch, **over)
        mesh = NamedMesh((1, 1), ("data", "model"))   # one device

    bundle = model_zoo.build(cfg, device=args.device)
    dev = bundle.device
    opt = AdamW(lr=args.lr, warmup_steps=20, total_steps=args.steps,
                state_dtype=cfg.opt_state_dtype)
    step_fn = make_train_step(bundle.loss_fn, opt,
                              num_microbatches=args.microbatches,
                              decay=model_zoo.decay_mask(cfg))
    pipe = TokenPipeline(cfg.vocab_size, args.batch, args.seq)

    pshard = tree_lib.flatten(sharding.param_shardings(
        mesh, model_zoo.abstract_params(cfg)))[0]
    sharded = sum(any(s.spec) for s in pshard)

    def init():
        params = bundle.init_params(0)
        return TrainState(params, opt.init(params))

    def batch_for_step(step):
        b = pipe.batch_for_step(step)
        out = {k: torch.from_numpy(v).to(dev, torch.long)
               for k, v in b.items()}
        if cfg.encdec is not None:
            frames = pipe.frames_for_step(step, cfg.d_model)
            out = {"frames": torch.from_numpy(frames).to(dev, cfg.jdtype),
                   "tokens": out["tokens"][:, : args.seq // 4],
                   "labels": out["labels"][:, : args.seq // 4]}
        return out

    with shardctx.use_mesh(mesh):
        trainer = Trainer(step_fn, batch_for_step, init(),
                          ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                          failure_at_step=args.fail_at)
        resumed = trainer.maybe_restore()
        print(f"arch={cfg.name} params={cfg.total_params()/1e6:.1f}M "
              f"devices=1 resumed={resumed} step={trainer.step}")
        print(f"mesh={'x'.join(map(str, mesh.axis_sizes))} "
              f"sharded_leaves={sharded}/{len(pshard)}")
        try:
            metrics = trainer.run(args.steps - trainer.step)
        except RuntimeError as e:
            print(f"FAILURE: {e}; restarting from last checkpoint...")
            trainer.maybe_restore()
            metrics = trainer.run(args.steps - trainer.step)
        ckpt_lib.wait()
    print(f"done: {metrics} straggler_events={trainer.straggler_events}")
    return trainer


if __name__ == "__main__":
    main()
