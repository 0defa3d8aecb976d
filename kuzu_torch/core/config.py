"""Config system: YAML + attribute access + CLI ``k=v`` overrides (a copy of
``kuzu/core/config.py``, which the port may not import).

Unifies the reference's two config stacks — the project's ``EasyDict`` YAML
wrapper (``src/utils/util.py:6-66``, precedence Defaults -> YAML -> CLI,
``train.py:39-61``) and the engine's ``get_cfg`` typed merge with fuzzy key
suggestions (``yolov12/ultralytics/cfg/__init__.py:268,448``) — into one
system: a dot-access ``Config`` dict, a packaged ``default.yaml``, typed
coercion of CLI strings, and close-match suggestions on unknown keys.
"""

from __future__ import annotations

import copy
import difflib
import json
from pathlib import Path
from typing import Any, Iterable, Mapping

import yaml

_DEFAULT_CFG_PATH = Path(__file__).resolve().parent.parent / "cfg" / "default.yaml"


class Config(dict):
    """dict with attribute access, recursive wrapping, and deep merge."""

    def __init__(self, data: Mapping[str, Any] | None = None, **kw: Any):
        super().__init__()
        for k, v in {**(dict(data) if data else {}), **kw}.items():
            self[k] = v

    def __setitem__(self, key: str, value: Any) -> None:
        if isinstance(value, Mapping) and not isinstance(value, Config):
            value = Config(value)
        elif isinstance(value, (list, tuple)):
            value = type(value)(
                Config(v) if isinstance(v, Mapping) and not isinstance(v, Config) else v
                for v in value
            )
        super().__setitem__(key, value)

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __deepcopy__(self, memo: dict) -> "Config":
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def merge(self, other: Mapping[str, Any]) -> "Config":
        """Recursive in-place merge; ``other`` wins. Returns self."""
        for k, v in other.items():
            if k in self and isinstance(self[k], Config) and isinstance(v, Mapping):
                self[k].merge(v)
            else:
                self[k] = v
        return self

    def to_dict(self) -> dict:
        def conv(v: Any) -> Any:
            if isinstance(v, Config):
                return {k: conv(x) for k, x in v.items() if not str(k).startswith("_")}
            if isinstance(v, (list, tuple)):
                return [conv(x) for x in v]
            return v

        return conv(self)

    def to_yaml(self, path: str | Path) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False, allow_unicode=True)


def load_yaml(path: str | Path) -> Config:
    with open(path) as f:
        return Config(yaml.safe_load(f) or {})


def coerce(value: str) -> Any:
    """Best-effort typed coercion of a CLI string value."""
    low = value.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("none", "null"):
        return None
    try:
        return json.loads(value)  # ints, floats, lists, dicts
    except (json.JSONDecodeError, ValueError):
        return value


def parse_overrides(argv: Iterable[str]) -> Config:
    """Parse yolo-style ``key=value`` CLI args (dots create nesting)."""
    cfg = Config()
    for arg in argv:
        if "=" not in arg:
            raise ValueError(f"override '{arg}' is not of the form key=value")
        key, value = arg.split("=", 1)
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, Config())
        node[parts[-1]] = coerce(value)
    return cfg


def check_keys(cfg: Mapping[str, Any], base: Mapping[str, Any]) -> None:
    """Raise with close-match suggestions for keys absent from the defaults."""
    unknown = [k for k in cfg if k not in base]
    if unknown:
        msgs = []
        for k in unknown:
            near = difflib.get_close_matches(k, list(base), n=1)
            hint = f" (did you mean '{near[0]}'?)" if near else ""
            msgs.append(f"'{k}' is not a valid config key{hint}")
        raise KeyError("; ".join(msgs))


def load_config(
    yaml_path: str | Path | None = None,
    overrides: Mapping[str, Any] | Iterable[str] | None = None,
    strict: bool = False,
) -> Config:
    """Defaults -> YAML file -> overrides, in increasing precedence."""
    cfg = load_yaml(_DEFAULT_CFG_PATH) if _DEFAULT_CFG_PATH.exists() else Config()
    if yaml_path is not None:
        cfg.merge(load_yaml(yaml_path))
    if overrides is not None:
        if not isinstance(overrides, Mapping):
            overrides = parse_overrides(overrides)
        if strict:
            check_keys(overrides, cfg)
        cfg.merge(overrides)
        # remember which keys the caller set explicitly (vs defaults/yaml):
        # validators/predictors use this to rebase onto a run's args.yaml
        # while keeping the user's actual overrides on top
        cfg["_explicit"] = sorted(
            set(overrides) | set(cfg.get("_explicit", []))
        )
    return cfg


def rebase_on_run_config(cfg, run_dir, mode: str = "val"):
    """Adopt a trained run's ``args.yaml`` as the base config, re-applying
    the caller's explicit overrides on top (minus ``model``) — the rebuilt
    architecture/imgsz/lora_rank then match the checkpoint. Shared by the
    standalone validators (Detect/Classify). Returns ``cfg`` unchanged when
    the run carries no ``args.yaml``."""
    from pathlib import Path

    args = Path(run_dir) / "args.yaml"
    if not args.exists():
        return cfg
    base = load_config(args)
    explicit = {
        k: cfg[k] for k in cfg.get("_explicit", []) if k in cfg and k != "model"
    }
    base.merge({**explicit, "mode": mode, "save": False})
    base.merge({"name": f"{base.get('name') or 'run'}-{mode}", "exist_ok": True})
    return base
