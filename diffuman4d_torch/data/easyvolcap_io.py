"""Minimal reader for easyvolcap-style ``intri.yml``/``extri.yml`` camera files.

These are OpenCV FileStorage YAML files. The reference imports easyvolcap's
``read_camera`` (camera_parser.py:50-52); we parse the files directly with a
small self-contained parser so there is no OpenCV/easyvolcap dependency.

Expected layout (per easyvolcap convention):
  intri.yml:  names: [..]; K_<name>: 3x3; (optional) H_<name>, W_<name>
  extri.yml:  names: [..]; R_<name> (3x3) or Rot_<name>; T_<name> (3x1)

Returned dict: {label: {"K": (3,3), "RT": (3,4), "H": int, "W": int}}.
"""

from __future__ import annotations

import os.path as osp
import re

import numpy as np


def _strip_yaml_directives(text: str) -> str:
    lines = []
    for line in text.splitlines():
        if line.startswith("%YAML") or line.strip() == "---":
            continue
        lines.append(line)
    return "\n".join(lines)


def _parse_opencv_yaml(path: str) -> dict:
    """Parse the subset of OpenCV FileStorage YAML used by easyvolcap."""
    with open(path, "r") as f:
        text = _strip_yaml_directives(f.read())

    data: dict = {}
    # names: either flow style ["00", "01"] or OpenCV's block style
    #   names:
    #      - "00"
    m = re.search(r"names:\s*\[(.*?)\]", text, re.DOTALL)
    if m:
        data["names"] = [
            s.strip().strip("\"'") for s in m.group(1).split(",") if s.strip()
        ]
    else:
        m = re.search(r"^names:\s*\n((?:\s*-\s*.+\n?)+)", text, re.MULTILINE)
        if m:
            data["names"] = [
                ln.split("-", 1)[1].strip().strip("\"'")
                for ln in m.group(1).splitlines()
                if "-" in ln
            ]

    # Matrices: key:\n  rows: r\n  cols: c\n  dt: d\n  data: [ ... ]
    pat = re.compile(
        r"^(\S+): !!opencv-matrix\s*\n"
        r"\s*rows:\s*(\d+)\s*\n"
        r"\s*cols:\s*(\d+)\s*\n"
        r"\s*dt:\s*\S+\s*\n"
        r"\s*data:\s*\[(.*?)\]",
        re.MULTILINE | re.DOTALL,
    )
    for key, rows, cols, body in pat.findall(text):
        vals = [float(v) for v in body.replace("\n", " ").split(",") if v.strip()]
        data[key] = np.array(vals, dtype=np.float64).reshape(int(rows), int(cols))

    # Scalars like H_00: 1024
    for key, val in re.findall(r"^(\w+):\s*(-?\d+(?:\.\d+)?)\s*$", text, re.MULTILINE):
        data.setdefault(key, float(val))
    return data


def read_easyvolcap_cameras(camera_path: str) -> dict[str, dict]:
    if osp.isdir(camera_path):
        intri_path = osp.join(camera_path, "intri.yml")
        extri_path = osp.join(camera_path, "extri.yml")
    else:
        # a single yml next to its sibling
        base = osp.dirname(camera_path)
        intri_path = osp.join(base, "intri.yml")
        extri_path = osp.join(base, "extri.yml")

    intri = _parse_opencv_yaml(intri_path)
    extri = _parse_opencv_yaml(extri_path)
    names = intri.get("names") or extri.get("names")
    if not names:
        raise ValueError(f"No camera names found in {intri_path}/{extri_path}")

    cams: dict[str, dict] = {}
    for name in names:
        K = intri[f"K_{name}"]
        R = extri.get(f"R_{name}")
        if R is None:
            R = extri[f"Rot_{name}"]
        if R.size == 3:  # rodrigues vector
            R = _rodrigues(R.reshape(3))
        T = extri[f"T_{name}"].reshape(3, 1)
        RT = np.concatenate([R, T], axis=1)
        H = int(intri.get(f"H_{name}", intri.get("H", -1)))
        W = int(intri.get(f"W_{name}", intri.get("W", -1)))
        cams[name] = {"K": K, "RT": RT, "H": H, "W": W}
    return cams


def _rodrigues(rvec: np.ndarray) -> np.ndarray:
    """Rotation vector -> rotation matrix (Rodrigues formula)."""
    theta = float(np.linalg.norm(rvec))
    if theta < 1e-12:
        return np.eye(3)
    k = rvec / theta
    K = np.array(
        [[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]], dtype=np.float64
    )
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)
