"""COCO-WholeBody skeleton topology and the sapiens drawing palette.

Factual data tables (the 133-keypoint COCO-WholeBody standard + the Meta
sapiens visualization palette, vendored by the reference at
scripts/preprocess/sapiens/lite/demo/classes_and_palettes.py). These are
required for pose-condition *format parity*: the diffusion model is trained
on skeleton maps rendered with exactly these links and colors.

Hands and face follow regular patterns, so the tables are generated
programmatically rather than spelled out.

The port's own copy of ``diffuman4d_tpu/preprocess/skeleton_data.py`` (numpy
only), held bit-equal to it by ``tests/test_torch_port_preprocess.py``.
"""

from __future__ import annotations

# sapiens palette (RGB)
RED = [255, 135, 135]
ORANGE = [248, 129, 81]
YELLOW = [255, 212, 59]
GREEN = [130, 186, 129]
TEAL = [99, 230, 190]
BLUE = [116, 192, 252]
PINK = [229, 153, 247]
PURPLE = [177, 151, 252]
WHITE = [255, 255, 255]

_FINGER_COLORS = [YELLOW, PINK, PURPLE, RED, TEAL]  # thumb..pinky


def _body_links() -> list[tuple[tuple[int, int], list[int]]]:
    return [
        ((15, 13), TEAL),  # left leg
        ((13, 11), TEAL),
        ((16, 14), YELLOW),  # right leg
        ((14, 12), YELLOW),
        ((11, 12), BLUE),  # pelvis
        ((5, 11), GREEN),  # torso left
        ((6, 12), ORANGE),  # torso right
        ((5, 6), BLUE),  # shoulders
        ((5, 7), TEAL),  # left arm
        ((6, 8), YELLOW),  # right arm
        ((7, 9), TEAL),
        ((8, 10), YELLOW),
        ((1, 2), BLUE),  # eyes
        ((0, 1), GREEN),  # nose-eyes
        ((0, 2), ORANGE),
        ((1, 3), GREEN),  # eye-ear
        ((2, 4), ORANGE),
        ((3, 5), GREEN),  # ear-shoulder
        ((4, 6), ORANGE),
        ((15, 17), TEAL),  # left foot: ankle -> big/small toe, heel
        ((15, 18), TEAL),
        ((15, 19), TEAL),
        ((16, 20), YELLOW),  # right foot
        ((16, 21), YELLOW),
        ((16, 22), YELLOW),
    ]


def _hand_links(root: int) -> list[tuple[tuple[int, int], list[int]]]:
    """21-keypoint hand: root + 5 fingers x 4 joints, chained."""
    links = []
    for f in range(5):
        base = root + 1 + 4 * f
        color = _FINGER_COLORS[f]
        links.append(((root, base), color))
        for j in range(3):
            links.append(((base + j, base + j + 1), color))
    return links


def coco_wholebody_skeleton() -> dict[int, dict]:
    """{link_id: {"link": (i, j), "color": rgb}} — ids 0-24 body+feet,
    25-44 left hand (root 91), 45-64 right hand (root 112)."""
    rows = _body_links() + _hand_links(91) + _hand_links(112)
    return {i: {"link": l, "id": i, "color": c} for i, (l, c) in enumerate(rows)}


def coco_wholebody_keypoint_colors() -> list[list[int]]:
    """Per-keypoint colors: 23 body/feet, 68 white face, 2x21 hands."""
    body = [
        BLUE,  # nose
        GREEN, ORANGE,  # eyes
        GREEN, ORANGE,  # ears
        TEAL, YELLOW,  # shoulders
        TEAL, YELLOW,  # elbows
        TEAL, YELLOW,  # wrists
        TEAL, YELLOW,  # hips
        TEAL, YELLOW,  # knees
        TEAL, YELLOW,  # ankles
        TEAL, TEAL, TEAL,  # left foot
        YELLOW, YELLOW, YELLOW,  # right foot
    ]
    face = [WHITE] * 68
    hand = [WHITE] + [c for c in _FINGER_COLORS for _ in range(4)]
    return body + face + hand + hand


NUM_KEYPOINTS = 133
# torso cross-links added by the reference drawer (draw_skeleton.py:93-98)
EXTRA_CROSS_LINKS = {
    65: {"link": (5, 12), "id": 65, "color": BLUE},
    66: {"link": (6, 11), "id": 66, "color": BLUE},
}
