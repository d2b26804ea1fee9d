"""Config-driven multi-leg experiment orchestration (port of
``repro.bench.experiments``: the sections are the port's,
``repro_torch.benchmarks.bench_*``).

One :class:`ExperimentSpec`, loaded from a JSON or TOML file, names every
leg of a benchmark campaign: which section runs, with which parameters,
swept over which axes.  This replaces the hand-rolled ``--sections`` dispatch
(the serverless-benchmarks idiom: the *config file* is the experiment, the
runner just executes it), so a sweep over sections × engine × K × D ×
source is one committed config instead of a shell loop.

Config shape (JSON; TOML maps 1:1)::

    {
      "name": "ci-smoke",
      "defaults": {"smoke": true},          // merged under every leg
      "legs": [
        {"section": "scaling", "params": {"k_values": [1, 8], "groups": 5,
                                          "device_sweep": false}},
        {"section": "serve",
         "matrix": {"k_values": [[1], [1, 8]]}}   // one leg per combo
      ]
    }

``matrix`` axes cross-multiply: every combination becomes its own leg with
the axis values merged over ``params``.  Leg params are validated against
the target section's ``main()`` signature before anything runs, so a typo
fails the whole campaign upfront, not after an hour of sweeps.

The port's committed configs live in ``src/repro_torch/benchmarks/
experiments/``; the reference's, in ``benchmarks/experiments/``, load and
validate here too.  Run with ``python -m repro_torch.benchmarks.run
--experiment <config> [--device cuda|cpu]`` (each leg's
``BENCH_<section>.json`` lands in ``--json-dir``, on the reporting schema,
covered by the trend gate automatically).
"""
from __future__ import annotations

import dataclasses
import inspect
import itertools
import json
import os
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

#: the benchmark sections (authoritative; repro_torch.benchmarks.run re-exports)
SECTIONS = (
    "hier", "kernels", "embed", "scaling", "cascade_kernel", "serve", "fleet",
    "query", "obs",
)

_SECTION_MODULES = {
    "hier": "repro_torch.benchmarks.bench_hier_update",
    "kernels": "repro_torch.benchmarks.bench_kernels",
    "embed": "repro_torch.benchmarks.bench_embed_grad",
    "scaling": "repro_torch.benchmarks.bench_scaling",
    "cascade_kernel": "repro_torch.benchmarks.bench_cascade_kernel",
    "serve": "repro_torch.benchmarks.bench_serve",
    "fleet": "repro_torch.benchmarks.bench_fleet",
    "query": "repro_torch.benchmarks.bench_query",
    "obs": "repro_torch.benchmarks.bench_obs",
}


class ExperimentError(ValueError):
    """An experiment config is malformed or names unknown sections/params."""


def _load_toml(path: str) -> Dict[str, Any]:
    try:
        import tomllib as toml_mod  # Python >= 3.11
    except ModuleNotFoundError:
        try:
            import tomli as toml_mod  # type: ignore[no-redef]
        except ModuleNotFoundError:
            raise ExperimentError(
                f"{path}: TOML configs need tomllib (Python 3.11+) or the "
                f"optional 'tomli' package; neither is available — use the "
                f"JSON config format instead"
            ) from None
    with open(path, "rb") as f:
        return toml_mod.load(f)


@dataclasses.dataclass(frozen=True)
class ExperimentLeg:
    """One benchmark invocation: a section plus the kwargs for its main."""

    section: str
    params: Tuple[Tuple[str, Any], ...] = ()
    name: str = ""

    @property
    def label(self) -> str:
        return self.name or self.section

    def kwargs(self) -> Dict[str, Any]:
        return dict(self.params)

    def validate(self) -> "ExperimentLeg":
        if self.section not in SECTIONS:
            raise ExperimentError(
                f"leg {self.label!r}: unknown section {self.section!r}; "
                f"known: {list(SECTIONS)}"
            )
        return self


def _freeze_params(params: Mapping[str, Any]) -> Tuple[Tuple[str, Any], ...]:
    def freeze(v: Any) -> Any:
        if isinstance(v, list):
            return tuple(freeze(x) for x in v)
        return v

    return tuple(sorted((str(k), freeze(v)) for k, v in params.items()))


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """A named, validated set of experiment legs."""

    name: str
    legs: Tuple[ExperimentLeg, ...]
    json_dir: Optional[str] = None
    source: str = ""  # config path or synthesis origin (diagnostics)

    def validate(self) -> "ExperimentSpec":
        if not self.name:
            raise ExperimentError("experiment spec needs a non-empty name")
        if not self.legs:
            raise ExperimentError(f"experiment {self.name!r} has no legs")
        for leg in self.legs:
            leg.validate()
        return self

    def sections(self) -> Tuple[str, ...]:
        return tuple(sorted({leg.section for leg in self.legs}))

    # -- construction --------------------------------------------------------
    @classmethod
    def from_dict(
        cls, payload: Mapping[str, Any], source: str = ""
    ) -> "ExperimentSpec":
        if not isinstance(payload, Mapping):
            raise ExperimentError(
                f"{source or 'config'}: experiment config must be a mapping"
            )
        unknown = set(payload) - {"name", "defaults", "legs", "json_dir"}
        if unknown:
            raise ExperimentError(
                f"{source or 'config'}: unknown top-level keys {sorted(unknown)}"
            )
        defaults = dict(payload.get("defaults") or {})
        raw_legs = payload.get("legs")
        if not isinstance(raw_legs, list) or not raw_legs:
            raise ExperimentError(
                f"{source or 'config'}: 'legs' must be a non-empty list"
            )
        legs: List[ExperimentLeg] = []
        for i, raw in enumerate(raw_legs):
            if not isinstance(raw, Mapping):
                raise ExperimentError(
                    f"{source or 'config'}: leg #{i} must be a mapping"
                )
            bad = set(raw) - {"section", "name", "params", "matrix"}
            if bad:
                raise ExperimentError(
                    f"{source or 'config'}: leg #{i} has unknown keys "
                    f"{sorted(bad)}"
                )
            section = raw.get("section")
            base = {**defaults, **dict(raw.get("params") or {})}
            matrix = dict(raw.get("matrix") or {})
            for axis, values in matrix.items():
                if not isinstance(values, list) or not values:
                    raise ExperimentError(
                        f"{source or 'config'}: leg #{i} matrix axis "
                        f"{axis!r} must be a non-empty list"
                    )
            combos = (
                [dict(zip(matrix, combo))
                 for combo in itertools.product(*matrix.values())]
                if matrix
                else [{}]
            )
            for combo in combos:
                suffix = "".join(
                    f",{k}={v}" for k, v in sorted(combo.items())
                )
                name = raw.get("name") or section or f"leg{i}"
                legs.append(
                    ExperimentLeg(
                        section=section,
                        params=_freeze_params({**base, **combo}),
                        name=f"{name}{suffix}" if suffix else name,
                    )
                )
        return cls(
            name=payload.get("name") or os.path.basename(source) or "experiment",
            legs=tuple(legs),
            json_dir=payload.get("json_dir"),
            source=source,
        ).validate()

    @classmethod
    def from_file(cls, path: str) -> "ExperimentSpec":
        if path.endswith(".toml"):
            payload = _load_toml(path)
        else:
            try:
                with open(path) as f:
                    payload = json.load(f)
            except (OSError, json.JSONDecodeError) as e:
                raise ExperimentError(f"{path}: unreadable config ({e})") from None
        return cls.from_dict(payload, source=path)


def _section_main(section: str) -> Callable:
    import importlib

    try:
        mod = importlib.import_module(_SECTION_MODULES[section])
    except ImportError as e:
        raise ExperimentError(
            f"section {section!r}: cannot import {_SECTION_MODULES[section]}: {e}"
        ) from None
    return mod.main


def validate_leg_params(leg: ExperimentLeg) -> None:
    """Check the leg's params against the section main's real signature —
    a typo'd axis fails the campaign before any leg runs."""
    sig = inspect.signature(_section_main(leg.section))
    unknown = set(leg.kwargs()) - set(sig.parameters)
    if unknown:
        raise ExperimentError(
            f"leg {leg.label!r}: section {leg.section!r} does not accept "
            f"{sorted(unknown)}; accepted: {sorted(sig.parameters)}"
        )


def run_spec(
    spec: ExperimentSpec, json_dir: Optional[str] = None, device: Optional[str] = None
) -> List[Tuple[ExperimentLeg, Any]]:
    """Execute every leg in order; returns ``[(leg, main() result)]``.

    Each section writes its ``BENCH_<section>.json`` into ``json_dir`` (or
    the spec's, or ``$BENCH_JSON_DIR``) via the reporting layer, exactly as
    the reference's dispatch does.  ``device`` (``"cuda"`` or ``"cpu"``),
    when given, is passed to every section's ``main`` and wins over a leg's
    own ``device``; otherwise the sections run on the card.
    """
    spec.validate()
    out_dir = json_dir or spec.json_dir
    if out_dir:
        os.environ["BENCH_JSON_DIR"] = out_dir
    for leg in spec.legs:  # validate everything before running anything
        validate_leg_params(leg)
    results: List[Tuple[ExperimentLeg, Any]] = []
    for leg in spec.legs:
        print(
            f"experiment,{spec.name},leg={leg.label},section={leg.section},"
            + ",".join(f"{k}={v}" for k, v in leg.params),
            flush=True,
        )
        kwargs = leg.kwargs()
        if device is not None:
            kwargs["device"] = device
        results.append((leg, _section_main(leg.section)(**kwargs)))
    return results
