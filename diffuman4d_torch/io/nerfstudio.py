"""Nerfstudio export (the port's own copy of ``diffuman4d_tpu/io/nerfstudio.py``;
reference: scripts/nerfstudio/diffuman4d_to_nerfstudio.py:14-56 and
sampling_runner.to_nerfstudio :79-84).

Rewrites the scene's ``transforms.json`` to point at the generated images,
splits out ``transforms_input.json`` for the input cameras, copies the
sparse point cloud for 3DGS initialization, and runs the alpha-matting
stage over the *generated* images like the reference
(diffuman4d_to_nerfstudio.py:25,42-51): fmasks + RGBA composites under
``images_alpha/{cam}/{frame}.png``, with both transforms files pointing at
the alpha PNGs. The matting model is pluggable (by default the
checkpoint-free ChromaKey matting; ``preprocess.background.BiRefNetMatting``
with a local checkpoint); ``matting=False`` skips the stage and references
the JPEGs directly, recording that in the export manifest.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import shutil


def export_to_nerfstudio(
    scene_dir: str,
    output_dir: str,
    input_spa_labels: list[str],
    image_ext: str = ".jpg",
    matting=None,
) -> str:
    transforms_path = osp.join(scene_dir, "transforms.json")
    if not osp.isfile(transforms_path):
        raise FileNotFoundError(transforms_path)
    with open(transforms_path) as f:
        tfs = json.load(f)

    # alpha-matte the generated images (reference default: BiRefNet over
    # result_dir/images -> fmasks + images_alpha, then transforms point at
    # the alpha PNGs)
    images_dir = osp.join(output_dir, "images")
    run_matting = matting is not False
    if run_matting:
        from diffuman4d_torch.preprocess.background import (
            ChromaKeyMatting,
            remove_background,
        )

        n_matted = remove_background(
            images_dir,
            osp.join(output_dir, "fmasks"),
            out_alpha_dir=osp.join(output_dir, "images_alpha"),
            matting=matting or ChromaKeyMatting(),
        )

    frames_all, frames_input = [], []
    for frame in tfs.get("frames", []):
        cam = str(frame.get("camera_label"))
        cam_dir = osp.join(images_dir, cam)
        if not osp.isdir(cam_dir):
            continue
        for fname in sorted(os.listdir(cam_dir)):
            if not fname.endswith(image_ext):
                continue
            nf = dict(frame)
            if run_matting:
                stem = osp.splitext(fname)[0]
                nf["file_path"] = f"images_alpha/{cam}/{stem}.png"
            else:
                nf["file_path"] = f"images/{cam}/{fname}"
            frames_all.append(nf)
            if cam in input_spa_labels:
                frames_input.append(nf)

    out_tfs = dict(tfs)
    out_tfs["frames"] = frames_all
    with open(osp.join(output_dir, "transforms.json"), "w") as f:
        json.dump(out_tfs, f, indent=2)

    out_tfs_in = dict(tfs)
    out_tfs_in["frames"] = frames_input
    with open(osp.join(output_dir, "transforms_input.json"), "w") as f:
        json.dump(out_tfs_in, f, indent=2)

    # sparse point cloud for 3DGS init (preprocess.sh:47 writes it into the
    # scene dir as sparse_pcd.ply)
    src_pcd = osp.join(scene_dir, "sparse_pcd.ply")
    if osp.isfile(src_pcd):
        shutil.copyfile(src_pcd, osp.join(output_dir, "sparse_pcd.ply"))

    manifest = {
        "num_frames": len(frames_all),
        "num_input_frames": len(frames_input),
        "alpha_matting": (
            f"{type(matting).__name__ if matting else 'ChromaKeyMatting'}: "
            f"{n_matted} images -> images_alpha/*.png"
            if run_matting
            else "disabled (matting=False): transforms reference raw JPEGs"
        ),
    }
    with open(osp.join(output_dir, "export_manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return output_dir
