"""Dataset download + Parquet-shard expansion (reference:
scripts/download/download_dataset.py).

The DNA-Rendering processed dataset ships as per-scene Parquet shards on
HF (``krahets/dna_rendering_processed``); this expands them into the
on-disk tree the dataset layer reads:

    {scene}/transforms.json, sparse_pcd.ply, cameras/(intri|extri).yml
    {scene}/images/{cam}/{frame}.webp
    {scene}/fmasks/{cam}/{frame}.png
    {scene}/skeletons/{cam}/{frame}.webp
    {scene}/poses_2d/{cam}/{frame}.json
    {scene}/poses_3d/{frame}.json

``extract_parquet_tree`` works fully offline on already-downloaded shards;
``download_and_extract_dataset`` additionally drives huggingface_hub when
network access exists (without it the call fails loudly with
instructions rather than hanging).

The port's own copy of ``diffuman4d_tpu/preprocess/download.py`` (numpy
only), held bit-equal to it by ``tests/test_torch_port_preprocess.py``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Iterator


def _write_text(p: Path, s: str, overwrite: bool) -> None:
    if not overwrite and p.exists():
        return
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(s, encoding="utf-8")


def _write_bytes(p: Path, b: bytes, overwrite: bool) -> None:
    if not overwrite and p.exists():
        return
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_bytes(b)


def iter_rows(parquet_path, batch_size: int = 1024) -> Iterator[dict[str, Any]]:
    import pyarrow.parquet as pq

    pf = pq.ParquetFile(parquet_path)
    for batch in pf.iter_batches(batch_size=batch_size):
        bd = batch.to_pydict()
        if not bd:
            continue
        n = len(next(iter(bd.values())))
        for i in range(n):
            yield {k: v[i] for k, v in bd.items()}


# per-type parquet schema: (row key, subdir, extension, binary?)
_PER_FRAME_TYPES = {
    "images": ("image", "images", "webp", True),
    "fmasks": ("fmask", "fmasks", "png", True),
    "skeletons": ("skeleton", "skeletons", "webp", True),
    "poses_2d": ("pose_2d", "poses_2d", "json", False),
}


def extract_parquet_tree(
    shards_root: str,
    out_dir: str,
    types: list[str] = ("images", "fmasks", "skeletons", "poses_2d", "poses_3d", "cameras"),
    overwrite: bool = False,
    batch_size: int = 1024,
) -> int:
    """Expand {shards_root}/{type}/{scene}.parquet shards into the scene
    tree under out_dir. Returns number of files written/seen."""
    root = Path(shards_root)
    out = Path(out_dir)
    count = 0

    if "cameras" in types and (root / "cameras").is_dir():
        for f in sorted((root / "cameras").glob("*.parquet")):
            for row in iter_rows(f, batch_size):
                scene = str(row["scene"])
                _write_text(out / scene / "transforms.json", row["cam_ns"], overwrite)
                if row.get("sparse_pcd") is not None:
                    _write_bytes(out / scene / "sparse_pcd.ply", row["sparse_pcd"], overwrite)
                if row.get("cam_evc_intri") is not None:
                    _write_text(out / scene / "cameras/intri.yml", row["cam_evc_intri"], overwrite)
                    _write_text(out / scene / "cameras/extri.yml", row["cam_evc_extri"], overwrite)
                count += 1

    if "poses_3d" in types and (root / "poses_3d").is_dir():
        for f in sorted((root / "poses_3d").glob("*.parquet")):
            for row in iter_rows(f, batch_size):
                _write_text(
                    out / str(row["scene"]) / "poses_3d" / f"{row['frame']}.json",
                    row["pose_3d"],
                    overwrite,
                )
                count += 1

    for typ, (key, subdir, ext, binary) in _PER_FRAME_TYPES.items():
        if typ not in types or not (root / subdir).is_dir():
            continue
        writer = _write_bytes if binary else _write_text
        for f in sorted((root / subdir).glob("*.parquet")):
            for row in iter_rows(f, batch_size):
                path = (
                    out
                    / str(row["scene"])
                    / subdir
                    / str(row["camera"])
                    / f"{row['frame']}.{ext}"
                )
                writer(path, row[key], overwrite)
                count += 1
    return count


def download_and_extract_dataset(
    repo_id: str = "krahets/dna_rendering_processed",
    out_dir: str | None = None,
    scenes: list[str] | None = None,
    types: list[str] = ("images", "fmasks", "skeletons", "poses_2d", "poses_3d", "cameras"),
    overwrite: bool = False,
) -> str:
    """HF snapshot_download of the requested scene shards + expansion
    (download_dataset.py:44-153)."""
    if out_dir is None:
        user, repo = repo_id.split("/")
        out_dir = f"./data/datasets--{user}--{repo}"
    allow_patterns = [
        f"{typ}/{scene}.parquet"
        for scene in (scenes or ["*"])
        for typ in types
    ]
    try:
        from huggingface_hub import snapshot_download
    except ImportError as e:
        raise ImportError(
            "huggingface_hub is required for downloading; for offline use, "
            "point extract_parquet_tree() at pre-downloaded shards"
        ) from e

    local_root = snapshot_download(
        repo_id=repo_id,
        repo_type="dataset",
        allow_patterns=allow_patterns,
        local_dir=out_dir + ".hf",
    )
    extract_parquet_tree(local_root, out_dir, types=types, overwrite=overwrite)
    return out_dir
