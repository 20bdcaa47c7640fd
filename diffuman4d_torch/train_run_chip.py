"""A training run on the card (counterpart of ``scripts/train_run_chip.py``).

Not a step timing: a run of the port's training loop (``training/loop.py``,
the code path users get) on the full 0.87B UNet with the window batcher on
a synthetic scene, showing
  * the loss curve (``metrics.jsonl``),
  * the host-offloaded fp32 EMA (staged device-to-host copies folded
    every 25 steps),
  * a second process resuming from the newest ``state_*.pt`` (fp32
    parameters, Adafactor state, step, EMA shadow) and running on.

Usage::

    python -m diffuman4d_torch.train_run_chip --steps 120     # session 1
    python -m diffuman4d_torch.train_run_chip --steps 300     # resumes, runs on
    python -m diffuman4d_torch.train_run_chip --report        # summary JSON

The defaults keep a step short (window 6 at 512^2 images, 64^2 latents) so
that a loss curve costs minutes; ``train_step_chip`` times the 12-frame
window at 128^2. The run is on the card; it raises when there is none
unless ``--device cpu`` is given (``--arch tiny`` and a small ``--size``
for the CPU tests). Checkpoints are the port's ``torch.save`` files.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import os.path as osp
import time

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
SCENE_LABEL = "0811_06"


def summarize(out_dir: str) -> dict:
    """The run's summary from ``metrics.jsonl`` and the state checkpoints
    (the keys of the JAX script's ``summarize``)."""
    path = osp.join(out_dir, "metrics.jsonl")
    recs = []
    if osp.isfile(path):
        with open(path) as f:
            recs = [json.loads(ln) for ln in f if ln.strip()]
    if not recs:
        return {"error": "no metrics yet"}
    first, last = recs[0], recs[-1]
    k = max(1, len(recs) // 5)
    head = sum(r["loss"] for r in recs[:k]) / k
    tail = sum(r["loss"] for r in recs[-k:]) / k
    states = sorted(d for d in os.listdir(out_dir) if d.startswith("state_"))
    return {
        "steps_logged": len(recs),
        "first_step": first["step"],
        "last_step": last["step"],
        "loss_first5th_mean": round(head, 4),
        "loss_last5th_mean": round(tail, 4),
        "loss_decreased": tail < head,
        "loss_series_every10": [round(r["loss"], 4) for r in recs if r["step"] % 10 == 0][:60],
        "domains_logged": sorted({r.get("domain", "?") for r in recs}),
        "state_checkpoints": states,
    }


def main(argv=None) -> dict:
    """Run one session (or, with ``--report``, only summarise); returns
    the JSON it prints."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--checkpoint-every", type=int, default=60)
    ap.add_argument("--out", default=osp.join(REPO, "runs", "d4d_train_run"))
    ap.add_argument("--scene", default=None)
    ap.add_argument("--report", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--arch", default="full", choices=["full", "tiny"])
    args = ap.parse_args(argv)
    if args.report:
        rep = summarize(args.out)
        print(json.dumps(rep), flush=True)
        return rep
    if args.scene is None:
        args.scene = osp.join(REPO, "runs", f"d4d_train_scene_{args.size}")

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the training run is on the card; pass "
                           "--device cpu to run on the CPU")
    logging.basicConfig(level=logging.INFO)

    from diffuman4d_torch.data import SpaTemDataset, make_synthetic_scene
    from diffuman4d_torch.models.unet import UNetConfig
    from diffuman4d_torch.models.vae import VAEConfig
    from diffuman4d_torch.sampling.loader import TINY_UNET, TINY_VAE, build_models
    from diffuman4d_torch.sampling.pipeline import Diffuman4DPipeline, SlidingConfig
    from diffuman4d_torch.schedulers.diffusion import Scheduler, SchedulerConfig
    from diffuman4d_torch.training.data import WindowBatcher, WindowBatcherConfig
    from diffuman4d_torch.training.loop import LoopConfig, train
    from diffuman4d_torch.training.trainer import TrainConfig

    t0 = time.perf_counter()
    if not osp.isfile(osp.join(args.scene, SCENE_LABEL, "transforms.json")):
        make_synthetic_scene(args.scene, SCENE_LABEL, num_cams=12, num_frames=8,
                             image_size=args.size, unique_frames=4)
        print(f"[train_run] scene rendered: {time.perf_counter() - t0:.1f}s", flush=True)

    # the production widths, random weights from seed 0, bf16 compute on the card
    tiny = args.arch == "tiny"
    unet, vae = build_models(UNetConfig(**TINY_UNET) if tiny else UNetConfig(),
                             VAEConfig(**TINY_VAE) if tiny else VAEConfig(), device=device,
                             dtype=torch.bfloat16 if device.type == "cuda" else torch.float32,
                             seed=0)
    print(f"[train_run] models built: {time.perf_counter() - t0:.1f}s", flush=True)

    dataset = SpaTemDataset(data_dir=args.scene, scene_label=SCENE_LABEL, height=args.size,
                            width=args.size, skeletons_uint8=True)
    pipeline = Diffuman4DPipeline(unet, vae, Scheduler(SchedulerConfig(kind="ddim")),
                                  sliding=SlidingConfig(), image_size=args.size, device=device)
    batcher = WindowBatcher(dataset, WindowBatcherConfig(
        window_size=args.frames, tem_labels=[f"{i:06d}" for i in range(8)],
        input_spa_labels=["01", "05", "09"]))
    tcfg = TrainConfig(
        learning_rate=args.lr,
        optimizer="adafactor",
        ema_decay=0.999,
        ema_host=True,  # the fp32 shadow in host memory (training/ema.py)
        ema_update_every=25,  # stage / fold every 25th step, decay raised to 25
        remat=True,
    )
    lcfg = LoopConfig(
        steps=args.steps,
        batch_size=1,
        window_size=args.frames,
        checkpoint_every=args.checkpoint_every,
        # odd: an even stride aliases with the two alternating domains and
        # logs only spatial steps
        log_every=3,
        out_dir=args.out,
    )
    t1 = time.perf_counter()
    train(pipeline, batcher, lcfg, tcfg)
    rep = summarize(args.out)
    rep["session_wall_s"] = round(time.perf_counter() - t1, 1)
    rep["device"] = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print("[train_run] " + json.dumps(rep), flush=True)
    return rep


if __name__ == "__main__":
    main()
