"""Config system: presets + dotted-key CLI overrides (the port's own copy
of ``diffuman4d_tpu/configs/presets.py``).

The dataclasses, presets, ``build_config``, ``_set_dotted`` and
``config_tree`` are the JAX package's, so one command line drives both
CLIs:

    python -m diffuman4d_torch.cli exp=demo_3d data.scene_label=0023_06

Two differences. ``ModelConfig.attn_implementation`` takes the port's
``auto | pallas | math``; the JAX package's ``xla`` is accepted and means
``math`` (the mapping is applied where the model is built,
``sampling/loader.py``). And override values are parsed here, without
PyYAML: :func:`parse_value` gives what ``yaml.safe_load`` gives for the
scalars and flow lists a command line carries.
"""

from __future__ import annotations

import dataclasses
import json
import re
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class DataConfig:
    # configs/data/dna_rendering.yaml
    data_dir: str = "./data/dna_rendering"
    camera_path_pat: str = "{data_dir}/{scene_label}/transforms.json"
    image_path_pat: str = "{data_dir}/{scene_label}/images/{spa_label}/{tem_label}.webp"
    fmask_path_pat: str = "{data_dir}/{scene_label}/fmasks/{spa_label}/{tem_label}.png"
    skeleton_path_pat: str = "{data_dir}/{scene_label}/skeletons/{spa_label}/{tem_label}.webp"
    scene_label: str = ""
    height: int = 1024
    width: int = 1024
    has_gt_target: bool = True


@dataclass
class ModelConfig:
    # configs/model/diffuman4d.yaml (HF repo / local checkpoint dir)
    model_dir: str = "./models/diffuman4d"
    dtype: str = "bf16"  # compute dtype: bf16 | fp32
    # checkpoint storage dtype; "fp32" keeps full-precision weights in HBM
    # (compute still casts to `dtype` at apply time) for PSNR-parity work.
    # Default mirrors the reference's bf16 from_pretrained
    # (sampling_utils.py:28-35).
    param_dtype: str = "bf16"  # bf16 | fp32
    attn_implementation: str = "auto"  # auto | pallas | math ("xla" = math)
    # architecture when model_dir has no checkpoint (random-init demo mode):
    # "full" = production SD2.1 shape, "tiny" = smoke-test shape
    arch: str = "full"


@dataclass
class SamplerConfig:
    # configs/sampler/sliding_default.yaml
    output_dir: str = "./results/${exp_name}/${scene_label}"
    window_size: int = 12
    sliding_stride: int = 1
    sliding_shift: int = 0
    bidirectional: bool = False
    num_denoising_steps: int = 1
    alternation_rounds: int = 3
    guidance_scale: float = 2.0
    spa_label_range: Optional[list] = field(default_factory=lambda: [0, 48, 1])
    tem_label_range: Optional[list] = field(default_factory=lambda: [0, 150, 1])
    spa_labels: Optional[list] = None
    tem_labels: Optional[list] = None
    input_spa_labels: list = field(default_factory=lambda: [1, 13, 25, 37])
    seed: int = 0
    save_debug_grids: bool = False
    tasks_per_wave: int = 0  # 0 = one task per device
    # domains whose CFG halves run as a sequential lax.map (halved UNet
    # live-set; identical math). "temporal" is required for the demo_4d
    # wave path on a single 16 GB chip — the fused batch-48 program alone
    # needs 14.54 GB (docs/TEMPORAL_WAVE_MEM.md)
    split_cfg_domains: list = field(default_factory=lambda: ["temporal"])


@dataclass
class RunConfig:
    exp_name: str = "default"
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    sampler: SamplerConfig = field(default_factory=SamplerConfig)
    sampling: bool = True
    to_nerfstudio: bool = True
    evaluating: bool = False
    result_dir: str = "./results"


# data presets (configs/data/*.yaml)
DATA_PRESETS: dict[str, dict] = {
    "dna_rendering": {
        "data_dir": "./data/dna_rendering_processed",
        "image_path_pat": "{data_dir}/{scene_label}/images/{spa_label}/{tem_label}.webp",
        "skeleton_path_pat": "{data_dir}/{scene_label}/skeletons/{spa_label}/{tem_label}.webp",
    },
    "fdvai": {
        "data_dir": "./data/fdvai",
        "image_path_pat": "{data_dir}/{scene_label}/images/{spa_label}/{tem_label}.jpg",
        "skeleton_path_pat": "{data_dir}/{scene_label}/skeletons/{spa_label}/{tem_label}.jpg",
    },
}

# sampler presets (configs/sampler/*.yaml)
SAMPLER_PRESETS: dict[str, dict] = {
    "sliding_default": {},
    "sliding_fast": {"sliding_stride": 2},
    "sliding_3d": {"alternation_rounds": 1},
    "sliding_premium": {"alternation_rounds": 5},
    "sliding_low_mem": {"window_size": 4, "guidance_scale": 1.0},
}

# experiment presets (configs/exp/*.yaml)
EXP_PRESETS: dict[str, dict] = {
    "demo_4d": {
        "sampler_preset": "sliding_fast",
        "data.scene_label": "0811_06",
        "data.has_gt_target": True,
        "sampler.spa_label_range": [0, 48, 1],
        "sampler.tem_label_range": [0, 150, 1],
        "sampler.input_spa_labels": [1, 13, 25, 37],
    },
    "demo_4d_tiny": {
        "sampler_preset": "sliding_fast",
        "data.scene_label": "0811_06",
        "data.has_gt_target": True,
        "sampler.spa_label_range": [0, 48, 1],
        "sampler.tem_label_range": [0, 16, 1],
        "sampler.input_spa_labels": [1, 13, 25, 37],
    },
    "demo_3d": {
        "sampler_preset": "sliding_3d",
        "data.scene_label": "0023_06",
        "data.has_gt_target": True,
        "sampler.spa_label_range": [0, 48, 1],
        "sampler.tem_label_range": [0, 1, 1],
        "sampler.input_spa_labels": [1, 13, 25, 37],
    },
}


def _set_dotted(cfg: Any, key: str, value: Any, raw: str | None = None) -> None:
    parts = key.split(".")
    obj = cfg
    for p in parts[:-1]:
        obj = getattr(obj, p)
    leaf = parts[-1]
    if not hasattr(obj, leaf):
        raise KeyError(f"Unknown config key: {key}")
    current = getattr(obj, leaf)
    # string-typed fields take the raw text untouched: YAML 1.1 would mangle
    # labels like "0326_07" (underscored digits parse as int 32607)
    if isinstance(current, str) and raw is not None:
        value = raw
    elif current is not None and not isinstance(value, type(current)):
        if isinstance(current, bool) and isinstance(value, str):
            value = value.lower() in ("1", "true", "yes")
        elif isinstance(current, (int, float)) and isinstance(value, str):
            value = type(current)(value)
    setattr(obj, leaf, value)


# YAML 1.1's implicit scalar types as PyYAML resolves them (its
# resolver.py), tried in PyYAML's order
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                  |[-+]?0[0-7_]+
                  |[-+]?(?:0|[1-9][0-9_]*)
                  |[-+]?0x[0-9a-fA-F_]+
                  |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"^[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")


def _sexagesimal(digits: str, cast) -> Any:
    value = cast(0)
    for part in digits.split(":"):
        value = value * 60 + cast(part)
    return value


def _number(text: str, cast) -> Any:
    text = text.replace("_", "").lower()
    sign = -1 if text[0] == "-" else 1
    text = text.lstrip("+-")
    if cast is float:
        if text in (".inf", ".nan"):
            return float("nan") if text == ".nan" else sign * float("inf")
        return sign * (_sexagesimal(text, float) if ":" in text else float(text))
    if text == "0":
        return 0
    if text.startswith(("0b", "0x")):
        return sign * int(text[2:], 2 if text[1] == "b" else 16)
    if text[0] == "0":
        return sign * int(text, 8)
    return sign * (_sexagesimal(text, int) if ":" in text else int(text))


def _scalar(text: str) -> Any:
    if text[:1] in ("'", '"'):
        if len(text) < 2 or text[-1] != text[0]:
            raise ValueError(f"unterminated quoted value: {text}")
        return json.loads(text) if text[0] == '"' else text[1:-1].replace("''", "'")
    if ((text and text[0] in "{&*!|>%@`") or text in ("-", "?") or text.startswith(("- ", "? "))
            or ": " in text or " #" in text or _TIMESTAMP.match(text)):
        raise ValueError(f"override value not supported (a YAML mapping, sequence, tag, "
                         f"alias, block or timestamp): {text!r}")
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _FLOAT.match(text):
        return _number(text, float)
    if _INT.match(text):
        return _number(text, int)
    if _NULL.match(text):
        return None
    return text


def _flow_items(body: str) -> list[str]:
    """Split a flow list's body at its top-level commas."""
    items, depth, start, quote = [], 0, 0, None
    for i, ch in enumerate(body):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        elif ch == "," and depth == 0:
            items.append(body[start:i].strip())
            start = i + 1
    items.append(body[start:].strip())
    if items[-1] == "":  # "[]" or a trailing comma
        items.pop()
    if "" in items:
        raise ValueError(f"empty item in flow list: [{body}]")
    return items


def parse_value(text: str) -> Any:
    """An override's value as ``yaml.safe_load`` reads it: null, bools,
    ints (decimal, octal, hex, binary, underscores, base 60), floats,
    quoted and plain strings, and flow lists of these, nested. Mappings,
    tags, aliases, block scalars and timestamps raise ``ValueError``."""
    text = text.strip()
    if text.startswith("["):
        if not text.endswith("]"):
            raise ValueError(f"unterminated flow list: {text}")
        return [parse_value(item) for item in _flow_items(text[1:-1])]
    return _scalar(text)


def build_config(overrides: list[str]) -> RunConfig:
    """Compose a RunConfig from ``key=value`` CLI overrides.

    ``exp=<name>`` applies an experiment preset; ``sampler=<preset>``
    applies a sampler preset; everything else is a dotted key.
    Order matters like Hydra: later overrides win."""
    cfg = RunConfig()
    kvs = []
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value: {ov}")
        k, v = ov.split("=", 1)
        kvs.append((k, v))

    def apply_sampler_preset(name: str) -> None:
        if name not in SAMPLER_PRESETS:
            raise KeyError(f"Unknown sampler preset: {name}")
        for k, v in SAMPLER_PRESETS[name].items():
            _set_dotted(cfg.sampler, k, v)

    for k, v in kvs:
        if k == "exp":
            if v not in EXP_PRESETS:
                raise KeyError(f"Unknown exp preset: {v}")
            cfg.exp_name = v
            for pk, pv in EXP_PRESETS[v].items():
                if pk == "sampler_preset":
                    apply_sampler_preset(pv)
                else:
                    _set_dotted(cfg, pk, pv)
        elif k == "sampler":
            apply_sampler_preset(v)
        elif k == "data" and v in DATA_PRESETS:
            for pk, pv in DATA_PRESETS[v].items():
                _set_dotted(cfg.data, pk, pv)
        else:
            _set_dotted(cfg, k, parse_value(v), raw=v)

    # interpolations (Hydra's ${...}) for the output dir
    cfg.sampler.output_dir = cfg.sampler.output_dir.replace(
        "${exp_name}", cfg.exp_name
    ).replace("${scene_label}", cfg.data.scene_label or "scene")
    return cfg


def config_tree(cfg: Any, indent: int = 0) -> str:
    """Render the resolved config (reference prints a rich tree,
    rich_utils.py:16-66)."""
    lines = []
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            lines.append(" " * indent + f.name + ":")
            lines.append(config_tree(v, indent + 2))
        else:
            lines.append(" " * indent + f"{f.name}: {v}")
    return "\n".join(lines)
