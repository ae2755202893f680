"""`SweepGrid` — a declarative scenario matrix as data: a copy of
`wittgenstein_tpu/matrix/grid.py` over the port's `ScenarioSpec`, so a
grid expands to the same cells and digests to the same `grid_digest()`
in both packages.

The reference's protocol packages sweep one axis at a time with
hand-rolled runners and print ad-hoc tables; the BFT-evaluation
campaigns this repo targets (PAPERS.md 2208.14745, 2309.17245) are the
opposite shape: ONE declarative grid over protocol params x N x
latency model x chaos schedule x attack x seeds whose value is the
comparable cross-cell report, not any single run.  `SweepGrid` is that
grid, frozen and JSON-able like `ScenarioSpec`:

  base   — a `ScenarioSpec` JSON object, the template every cell
           starts from;
  axes   — an ordered list of named axes.  Each axis either names one
           override path (``field``: a spec field like ``latency_model``
           / ``seeds`` / ``fault_schedule``, or ``params.<kwarg>``) with
           a value list, or pairs several paths per value (``field``
           omitted, every value a ``{path: value}`` dict — e.g. an
           engine/K axis that must move both fields together);
  exclude — label-matching rules (``{axis_name: label}``); a cell
           matching EVERY entry of any rule is dropped from the
           expansion (the classic "batched engine x K=1 is not a
           config" hole-punch).

`expand()` is DETERMINISTIC: the Cartesian product in declared axis
order, row-major, exclusions filtered — two processes expanding the
same grid JSON enumerate byte-identical cells.  Each cell's id is its
label path (``"N=64/lat=fixed30/chaos=clean/seed=s3"``), stable under
exclusion-rule changes, and its spec is a full `ScenarioSpec` (a
malformed cell refuses at expansion, naming the cell — the CLI's
exit-2 / HTTP-400 path).  `grid_digest()` is the content digest of the
canonical JSON: every ledger row and report a grid produces carries
it, so thousands of rows join back to ONE grid by construction.
"""

from __future__ import annotations

import dataclasses
import json

from ..serve.spec import ScenarioSpec

#: grid schema version (bump on field changes; readers key on it)
SCHEMA = 1

#: spec fields an axis may override (everything but the schema pin)
SPEC_FIELDS = tuple(sorted(
    f.name for f in dataclasses.fields(ScenarioSpec) if f.name != "schema"))

#: the adversity paths — axes touching these get fault-free twin
#: resolution in the MatrixReport (impact deltas vs the clean cell)
ADVERSITY_FIELDS = ("fault_schedule", "attack")


def _err(msg: str) -> ValueError:
    return ValueError(f"SweepGrid: {msg}")


def _check_path(path, axis_name: str):
    if not isinstance(path, str):
        raise _err(f"axis {axis_name!r}: override path {path!r} must be "
                   "a string")
    if path.startswith("params.") and len(path) > len("params."):
        return
    if path not in SPEC_FIELDS:
        raise _err(f"axis {axis_name!r}: unknown override path {path!r}; "
                   f"use 'params.<ctor kwarg>' or a spec field "
                   f"({', '.join(SPEC_FIELDS)})")


def _default_label(value) -> str | None:
    """Scalar values label themselves; structured values (schedules,
    paired overrides, attacks) need explicit labels — None signals
    'ask the author'."""
    if value is None:
        return "none"
    if isinstance(value, bool):
        return str(value).lower()
    if isinstance(value, (int, float, str)):
        return str(value)
    if isinstance(value, (list, tuple)) and all(
            isinstance(v, (int, float, str, bool)) for v in value):
        return ",".join(str(v) for v in value)
    return None


@dataclasses.dataclass(frozen=True)
class Axis:
    """One named sweep dimension (normalized; see module docstring)."""

    name: str
    values: tuple
    labels: tuple
    field: str | None = None        # None = paired-override values

    def to_json(self) -> dict:
        out = {"name": self.name, "values": list(self.values),
               "labels": list(self.labels)}
        if self.field is not None:
            out["field"] = self.field
        return out

    @property
    def adversity(self) -> bool:
        """Does this axis move a fault/attack path?  (Twin resolution.)"""
        if self.field is not None:
            return self.field in ADVERSITY_FIELDS
        return any(p in ADVERSITY_FIELDS for v in self.values
                   if isinstance(v, dict) for p in v)

    def clean_label(self) -> str | None:
        """The label of this adversity axis's fault-free value (the
        twin every adverse cell is compared against), or None when the
        axis has no clean value."""
        for val, lab in zip(self.values, self.labels):
            if self.field is not None:
                if val is None:
                    return lab
            elif isinstance(val, dict) and all(
                    val.get(p) is None for p in ADVERSITY_FIELDS
                    if p in val):
                return lab
        return None


@dataclasses.dataclass(frozen=True)
class Cell:
    """One expanded grid cell: its stable id (the label path), the
    per-axis labels, and the full `ScenarioSpec`."""

    id: str
    labels: dict                    # axis name -> value label
    spec: ScenarioSpec


@dataclasses.dataclass(frozen=True)
class SweepGrid:
    """See the module docstring.  Frozen; hash by canonical JSON."""

    base: dict
    axes: tuple = ()
    exclude: tuple = ()
    name: str = "grid"
    schema: int = SCHEMA

    def __post_init__(self):
        if not isinstance(self.base, dict) or "protocol" not in self.base:
            raise _err("base must be a ScenarioSpec JSON object with a "
                       "'protocol' field (serve/spec.py schema)")
        object.__setattr__(self, "base", dict(self.base))
        axes = []
        seen = set()
        for raw in self.axes:
            axes.append(self._norm_axis(raw))
            if axes[-1].name in seen:
                raise _err(f"duplicate axis name {axes[-1].name!r}")
            seen.add(axes[-1].name)
        if not axes:
            raise _err("a grid needs at least one axis (a single cell "
                       "is a plain ScenarioSpec — submit it to "
                       "/w/batch/submit instead)")
        object.__setattr__(self, "axes", tuple(axes))
        rules = []
        for rule in self.exclude:
            if not isinstance(rule, dict) or not rule:
                raise _err(f"exclusion rule {rule!r} must be a non-empty "
                           "{axis_name: label} object")
            by_name = {a.name: a for a in axes}
            for k, v in rule.items():
                if k not in by_name:
                    raise _err(f"exclusion rule names unknown axis {k!r}; "
                               f"axes: {sorted(by_name)}")
                if str(v) not in by_name[k].labels:
                    raise _err(
                        f"exclusion rule value {v!r} is not a label of "
                        f"axis {k!r} (labels: {list(by_name[k].labels)})")
            rules.append({k: str(v) for k, v in sorted(rule.items())})
        object.__setattr__(self, "exclude", tuple(rules))

    @staticmethod
    def _norm_axis(raw) -> Axis:
        if isinstance(raw, Axis):
            raw = raw.to_json()
        if not isinstance(raw, dict):
            raise _err(f"axis {raw!r} must be an object with "
                       "name/values[/field/labels]")
        unknown = set(raw) - {"name", "field", "values", "labels"}
        if unknown:
            raise _err(f"axis {raw.get('name', raw)!r}: unknown key(s) "
                       f"{sorted(unknown)}; known: name field values "
                       "labels")
        name = raw.get("name")
        if not name or not isinstance(name, str):
            raise _err(f"axis {raw!r} needs a non-empty string 'name'")
        values = raw.get("values")
        if not isinstance(values, (list, tuple)) or not values:
            raise _err(f"axis {name!r} needs a non-empty 'values' list")
        field = raw.get("field")
        if field is not None:
            _check_path(field, name)
        else:
            for v in values:
                if not isinstance(v, dict) or not v:
                    raise _err(
                        f"axis {name!r} has no 'field', so every value "
                        "must be a non-empty {path: value} override "
                        f"object (the paired-axis form); got {v!r}")
                for p in v:
                    _check_path(p, name)
        labels = raw.get("labels")
        if labels is None:
            labels = [_default_label(v) for v in values]
            missing = [i for i, lab in enumerate(labels) if lab is None]
            if missing:
                raise _err(
                    f"axis {name!r}: values at index(es) {missing} are "
                    "structured (dict/schedule) and cannot label "
                    "themselves — pass explicit 'labels' (one short "
                    "string per value)")
        labels = [str(x) for x in labels]
        if len(labels) != len(values):
            raise _err(f"axis {name!r}: {len(labels)} labels for "
                       f"{len(values)} values")
        if len(set(labels)) != len(labels):
            raise _err(f"axis {name!r}: duplicate labels {labels} — "
                       "cell ids are label paths and must be unique")
        bad = [lab for lab in labels if "/" in lab or "=" in lab]
        if bad:
            raise _err(f"axis {name!r}: label(s) {bad} contain '/' or "
                       "'=' (reserved by the cell-id path form)")
        return Axis(name=str(name), values=tuple(values),
                    labels=tuple(labels), field=field)

    def __hash__(self):
        # the dataclass-generated field-tuple hash would TypeError on
        # the dict-typed `base`; content identity IS the canonical JSON
        return hash(self.canonical_json())

    # ------------------------------------------------------- serialization

    def to_json(self) -> dict:
        return {"schema": self.schema, "name": self.name,
                "base": dict(self.base),
                "axes": [a.to_json() for a in self.axes],
                "exclude": [dict(r) for r in self.exclude]}

    def canonical_json(self) -> str:
        return json.dumps(self.to_json(), sort_keys=True,
                          separators=(",", ":"))

    @classmethod
    def from_json(cls, data) -> "SweepGrid":
        """Inverse of `to_json` (dict or JSON string); unknown keys are
        refused with the known list — the `ScenarioSpec.from_json`
        contract (a typo'd key silently dropped would digest as a
        different grid than the author meant)."""
        if isinstance(data, (str, bytes)):
            data = json.loads(data)
        if not isinstance(data, dict):
            raise _err(f"expected a JSON object, got "
                       f"{type(data).__name__}")
        known = {"schema", "name", "base", "axes", "exclude"}
        unknown = set(data) - known
        if unknown:
            raise _err(f"unknown field(s) {sorted(unknown)}; known: "
                       f"{sorted(known)}")
        if data.get("schema", SCHEMA) != SCHEMA:
            raise _err(f"unsupported schema {data.get('schema')!r} "
                       f"(this reader understands schema {SCHEMA})")
        if "base" not in data:
            raise _err("missing required field 'base' (a ScenarioSpec "
                       "JSON object)")
        kw = {k: data[k] for k in known & set(data)}
        for key in ("axes", "exclude"):
            if key in kw:
                kw[key] = tuple(kw[key])
        return cls(**kw)

    def grid_digest(self) -> str:
        """Content digest of the whole grid — what every per-cell
        ledger row and the MatrixReport carry (obs/ledger.digest)."""
        from ..obs.ledger import digest
        return digest(self.to_json())

    # ----------------------------------------------------------- expansion

    def cell_id(self, labels: dict) -> str:
        """The stable id of the cell at these axis labels."""
        return "/".join(f"{a.name}={labels[a.name]}" for a in self.axes)

    def _excluded(self, labels: dict) -> bool:
        return any(all(labels.get(k) == v for k, v in rule.items())
                   for rule in self.exclude)

    def n_cells_raw(self) -> int:
        """Product of axis lengths, BEFORE exclusion filtering."""
        n = 1
        for a in self.axes:
            n *= len(a.values)
        return n

    def expand(self) -> list:
        """Deterministic cell list (module docstring).  A cell whose
        merged spec is malformed refuses with the cell id prefixed —
        grid authoring errors surface before anything compiles."""
        import copy
        import itertools

        cells = []
        for combo in itertools.product(*(range(len(a.values))
                                         for a in self.axes)):
            labels = {a.name: a.labels[i]
                      for a, i in zip(self.axes, combo)}
            if self._excluded(labels):
                continue
            merged = copy.deepcopy(self.base)
            for a, i in zip(self.axes, combo):
                val = a.values[i]
                overrides = {a.field: val} if a.field is not None else val
                for path, v in overrides.items():
                    if path.startswith("params."):
                        merged.setdefault("params", {})[
                            path[len("params."):]] = copy.deepcopy(v)
                    elif v is None:
                        # a None axis value CLEARS the field back to the
                        # spec default (the fault-free / default-model
                        # twin cells) rather than forcing null into
                        # non-nullable fields
                        merged.pop(path, None)
                    else:
                        merged[path] = copy.deepcopy(v)
            cid = self.cell_id(labels)
            try:
                spec = ScenarioSpec.from_json(merged)
            except (ValueError, TypeError) as e:
                raise _err(f"cell {cid!r}: {e}") from None
            cells.append(Cell(id=cid, labels=labels, spec=spec))
        if not cells:
            raise _err("exclusion rules removed every cell — nothing "
                       "to run (loosen the rules or drop an axis)")
        return cells

    # ----------------------------------------------------------- twin map

    def twin_id(self, labels: dict) -> str | None:
        """The fault-free/attack-free twin of the cell at `labels`:
        same labels with every adversity axis at its clean value.
        None when the cell IS clean, or when some adversity axis has
        no clean value to fall back to."""
        adversity = [(a, a.clean_label()) for a in self.axes
                     if a.adversity]
        if not adversity:
            return None
        twin = dict(labels)
        moved = False
        for axis, clean in adversity:
            if labels.get(axis.name) == clean:
                continue
            if clean is None:
                return None
            twin[axis.name] = clean
            moved = True
        if not moved:
            return None                 # the cell is its own twin
        if self._excluded(twin):
            return None
        return self.cell_id(twin)
