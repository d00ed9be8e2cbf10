"""Layered experiment configuration, copied verbatim from the JAX package's
``surreal_tpu/session/config.py`` so the port imports no module of that
package.

Capability parity with the reference's ``surreal/session/config.py`` +
``default_configs.py`` (SURVEY.md §5.6): attribute-access nested dicts, an
``extend()`` that recursively merges user overrides onto a base tree while
enforcing required keys, and the three-tree split the whole framework is
organised around:

- ``learner_config`` — algorithm + model hyperparameters
- ``env_config``     — environment name, obs pipeline, action repeat …
- ``session_config`` — folders, schedules, and (new here) the ``topology``
  block that selects the TPU mesh instead of the reference's process-group
  port wiring.

Unlike the reference there is no port/host section: components that used to
be separate processes are modules inside one SPMD program.
"""

from __future__ import annotations

import copy
import json
from typing import Any, Iterator, Mapping

# Sentinel for keys the user MUST supply (the reference used the string
# '_req_' inside its default config trees for the same purpose).
REQUIRED = "_req_"
# Sentinel for keys that are optional-with-no-default.
OPTIONAL = "_opt_"


class ConfigError(Exception):
    pass


class Config(dict):
    """Nested dict with attribute access and base-extend semantics."""

    def __init__(self, data: Mapping | None = None, **kwargs: Any):
        super().__init__()
        merged = dict(data or {})
        merged.update(kwargs)
        for key, value in merged.items():
            self[key] = value

    # -- dict behaviour -----------------------------------------------------
    def __setitem__(self, key: str, value: Any) -> None:
        if isinstance(value, Mapping) and not isinstance(value, Config):
            value = Config(value)
        super().__setitem__(key, value)

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError:
            raise AttributeError(
                f"Config has no key {key!r}; available: {sorted(self.keys())}"
            ) from None

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __delattr__(self, key: str) -> None:
        try:
            del self[key]
        except KeyError:
            raise AttributeError(key) from None

    def __deepcopy__(self, memo: dict) -> "Config":
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    # -- extend / validate --------------------------------------------------
    def extend(self, base: Mapping) -> "Config":
        """Merge ``self`` (overrides) onto ``base`` (defaults); validate.

        Returns a new Config. Keys present only in ``base`` keep their
        defaults; keys present in both are overridden by ``self``; nested
        dicts merge recursively; REQUIRED placeholders left unfilled raise.
        Unknown override keys are allowed (the reference permitted ad-hoc
        additions) but nested dict/scalar mismatches raise.
        """
        out = _merge(Config(base), self, path="")
        _check_required(out, path="")
        return out

    def flatten(self, sep: str = ".") -> dict[str, Any]:
        flat: dict[str, Any] = {}

        def rec(node: "Config", prefix: str) -> None:
            for k, v in node.items():
                full = f"{prefix}{sep}{k}" if prefix else str(k)
                if isinstance(v, Config):
                    rec(v, full)
                else:
                    flat[full] = v

        rec(self, "")
        return flat

    def override_from_dotlist(self, items: Iterator[str]) -> "Config":
        """Apply ``a.b.c=value`` CLI-style overrides in place (values parsed
        as JSON when possible, else kept as strings)."""
        for item in items:
            if "=" not in item:
                raise ConfigError(f"override {item!r} is not of form key=value")
            dotted, raw = item.split("=", 1)
            try:
                value = json.loads(raw)
            except json.JSONDecodeError:
                value = raw
            node = self
            *parents, leaf = dotted.split(".")
            for p in parents:
                if p not in node or not isinstance(node[p], Config):
                    node[p] = Config()
                node = node[p]
            node[leaf] = value
        return self

    def to_dict(self) -> dict:
        return {
            k: (v.to_dict() if isinstance(v, Config) else v) for k, v in self.items()
        }

    def dumps(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=str)


def _merge(base: Config, override: Mapping, path: str) -> Config:
    out = Config(copy.deepcopy(base))
    for key, value in override.items():
        full = f"{path}.{key}" if path else str(key)
        if (
            isinstance(value, str)
            and value in (REQUIRED, OPTIONAL)
            and key in out
            and not (isinstance(out[key], str) and out[key] in (REQUIRED, OPTIONAL))
        ):
            # an unfilled placeholder carried in an override tree never
            # stomps a real base value (comes up when a partially-filled
            # bundle is re-extended onto per-algorithm defaults)
            continue
        if key in out and isinstance(out[key], Config):
            if isinstance(value, Mapping):
                out[key] = _merge(out[key], value, full)
            elif value is None:
                out[key] = None  # explicit disable of a subtree
            else:
                raise ConfigError(f"{full}: cannot override dict with {type(value).__name__}")
        else:
            out[key] = copy.deepcopy(value)
    return out


def _check_required(node: Config, path: str) -> None:
    for key, value in node.items():
        full = f"{path}.{key}" if path else str(key)
        if isinstance(value, Config):
            _check_required(value, full)
        elif isinstance(value, str) and value == REQUIRED:
            raise ConfigError(f"required config key {full} was not provided")
        elif isinstance(value, str) and value == OPTIONAL:
            node[key] = None
