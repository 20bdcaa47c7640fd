"""Preprocessing orchestrator (the port's copy of
``diffuman4d_tpu/preprocess/pipeline.py``; reference:
scripts/preprocess/preprocess.sh).

Runs the five-stage pipeline over a scene directory:

    remove_background -> carve_vhull -> predict_keypoints ->
    triangulate_skeleton -> draw_skeleton

Each stage is resumable (skip_exists) and independently invokable:

    python -m diffuman4d_torch.preprocess.pipeline <scene_dir> \
        --actions remove_background,carve_vhull,triangulate_skeleton,draw_skeleton

Model-based stages (BiRefNet matting, Sapiens pose) take optional local
checkpoint paths; without them, remove_background falls back to chroma-key
matting and predict_keypoints requires a checkpoint (or existing
poses_sapiens/ from the released dataset). The model stages and the hull
carving run on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os.path as osp


ALL_ACTIONS = [
    "remove_background",
    "carve_vhull",
    "predict_keypoints",
    "triangulate_skeleton",
    "draw_skeleton",
]


def run_preprocess(
    scene_dir: str,
    actions: list[str],
    birefnet_dir: str | None = None,
    sapiens_checkpoint: str | None = None,
    image_size: int = 1024,
    skip_exists: bool = True,
    device: str = "cuda",
) -> None:
    scene_dir = osp.abspath(scene_dir)
    camera_path = osp.join(scene_dir, "transforms.json")

    if "remove_background" in actions:
        from diffuman4d_torch.preprocess.background import (
            BiRefNetMatting,
            ChromaKeyMatting,
            remove_background,
        )

        matting = (
            BiRefNetMatting(birefnet_dir, image_size=image_size, device=device)
            if birefnet_dir
            else ChromaKeyMatting()
        )
        n = remove_background(
            osp.join(scene_dir, "images"),
            osp.join(scene_dir, "fmasks"),
            out_alpha_dir=osp.join(scene_dir, "images_alpha"),
            matting=matting,
            skip_exists=skip_exists,
        )
        print(f"[preprocess] remove_background: {n} frames")

    if "carve_vhull" in actions:
        from diffuman4d_torch.preprocess.visual_hull import carve_scene
        import shutil

        outs = carve_scene(
            osp.join(scene_dir, "fmasks"),
            camera_path,
            osp.join(scene_dir, "surfs"),
            device=device,
        )
        # first frame's hull initializes 3DGS (preprocess.sh:47)
        if outs:
            shutil.copyfile(outs[0], osp.join(scene_dir, "sparse_pcd.ply"))
        print(f"[preprocess] carve_vhull: {len(outs)} frames")

    if "predict_keypoints" in actions:
        from diffuman4d_torch.preprocess.keypoints import (
            TorchscriptPoseModel,
            predict_keypoints_dir,
        )

        if sapiens_checkpoint is None:
            raise ValueError(
                "predict_keypoints needs --sapiens-checkpoint (local sapiens-"
                "lite torchscript file); skip this action if poses_sapiens/ "
                "already exists from the released dataset"
            )
        model = TorchscriptPoseModel(sapiens_checkpoint, device=device)
        n = predict_keypoints_dir(
            osp.join(scene_dir, "images"),
            osp.join(scene_dir, "poses_sapiens"),
            model,
            fmasks_dir=osp.join(scene_dir, "fmasks"),
            skip_exists=skip_exists,
        )
        print(f"[preprocess] predict_keypoints: {n} frames")

    if "triangulate_skeleton" in actions:
        from diffuman4d_torch.preprocess.triangulate import triangulate_skeleton_dir

        kp2d_dir = osp.join(scene_dir, "poses_sapiens")
        if not osp.isdir(kp2d_dir):
            kp2d_dir = osp.join(scene_dir, "poses_2d")
        n = triangulate_skeleton_dir(
            camera_path,
            kp2d_dir,
            osp.join(scene_dir, "poses_3d"),
            out_kp2d_proj_dir=osp.join(scene_dir, "poses_2d"),
            out_pcd_dir=osp.join(scene_dir, "poses_pcd"),
            skip_exists=skip_exists,
        )
        print(f"[preprocess] triangulate_skeleton: {n} frames")

    if "draw_skeleton" in actions:
        from diffuman4d_torch.preprocess.draw_skeleton import draw_skeletons

        n = draw_skeletons(
            osp.join(scene_dir, "poses_2d"),
            osp.join(scene_dir, "skeletons"),
            kp2d_canvas_shape=(image_size, image_size),
            out_kpmap_shape=(image_size, image_size),
            skip_exists=skip_exists,
        )
        print(f"[preprocess] draw_skeleton: {n} frames")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("scene_dir")
    p.add_argument("--actions", default=",".join(ALL_ACTIONS))
    p.add_argument("--birefnet-dir", default=None)
    p.add_argument("--sapiens-checkpoint", default=None)
    p.add_argument("--image-size", type=int, default=1024)
    p.add_argument("--no-skip-exists", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    actions = [a.strip() for a in args.actions.split(",") if a.strip()]
    unknown = set(actions) - set(ALL_ACTIONS)
    if unknown:
        raise SystemExit(f"unknown actions: {unknown}; valid: {ALL_ACTIONS}")
    run_preprocess(
        args.scene_dir,
        actions,
        birefnet_dir=args.birefnet_dir,
        sapiens_checkpoint=args.sapiens_checkpoint,
        image_size=args.image_size,
        skip_exists=not args.no_skip_exists,
        device=args.device,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
