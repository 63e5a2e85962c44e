"""The traced tier of the port's lint: rules over recorded operations.

The AST tier checks what the source says; this tier checks what a call
of the port actually issues.  A :class:`Recorder` (a
``torch.utils._python_dispatch.TorchDispatchMode``) records every aten
operation one call makes, with its dtypes, shapes and device; each
call of the photon step (the kernel on the card, its plain version on
the CPU) is marked as one ``photon_step`` event, and the operations of
the plain version inside it are flagged ``in_step`` (on the card they
are the kernel's own arithmetic, not operations the host issues).  The
photon steps split a run into rounds: the operations between two of
them are one round of the round loop.  Of the plain version's own
operations only those that add at indices are kept (REP802 reads them).

The targets (:mod:`repro_torch.lint.traced.targets`) are real calls at
a small size on the CPU: ``sim`` (one ``simulate_fixed``), ``replay``
(both passes of ``replay_jacobian``), ``pool`` (a device process's
chunk function, run in this process) and ``simulate-many`` (three
scenarios).  The rules (:mod:`repro_torch.lint.traced.rules`, REP801 to
REP805) yield the same :class:`~repro_torch.lint.Finding` objects as
the AST tier.

Suppression: an operation has no source line for a pragma, so the
traced tier reads a committed allow file (``.tracelint-torch-allow.json``),
each entry with its ``why`` and a ``max`` on how many findings it may
absorb; the traced baseline (``.tracelint-torch.json``) stays empty.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Callable, Iterable, Iterator

from repro_torch.lint import Finding, LintReport, apply_baseline

__all__ = [
    "Op", "Recording", "Recorder", "TraceTarget", "TracedRule",
    "run_traced_lint", "load_allowlist", "allowlist_path",
    "traced_baseline_path", "ALLOWLIST_NAME", "TRACED_BASELINE_NAME",
    "HOST_READ", "STEP",
]

ALLOWLIST_NAME = ".tracelint-torch-allow.json"
TRACED_BASELINE_NAME = ".tracelint-torch.json"
ALLOWLIST_VERSION = 1

# the operation a host read of a device value issues
HOST_READ = "aten::_local_scalar_dense"
# the name of the photon step's own event
STEP = "repro_torch::photon_step"
# the operations of a photon step's plain version that are recorded
# (the ones that add at indices, REP802's); the rest are its arithmetic
IN_STEP_KEPT = ("aten::index_add", "aten::scatter_add", "aten::scatter_reduce",
                "aten::index_put", "aten::_index_put_impl", "aten::put")
# operations that launch nothing on a device (views, allocations)
NO_LAUNCH = frozenset({
    "aten::view", "aten::_unsafe_view", "aten::empty", "aten::empty_like",
    "aten::empty_strided", "aten::as_strided", "aten::select",
    "aten::slice", "aten::unsqueeze", "aten::squeeze", "aten::expand",
    "aten::permute", "aten::t", "aten::transpose", "aten::alias",
    "aten::detach", "aten::lift_fresh", "aten::reshape", "aten::unbind",
    "aten::split", "aten::split_with_sizes", "aten::_reshape_alias",
    "aten::unflatten", "aten::flatten", "aten::squeeze_",
    "aten::unsqueeze_", "aten::set_", "aten::resize_"})


@dataclasses.dataclass(frozen=True)
class Op:
    """One recorded operation."""

    name: str                 # "aten::add.Tensor", or STEP
    dtypes: tuple             # its tensor outputs' dtypes, as strings
    shapes: tuple             # and shapes
    devices: tuple            # the device types it touched
    kwargs: tuple = ()        # its keyword arguments' names and values
    bools: tuple = ()         # its positional bool arguments
    in_step: bool = False     # inside a photon step's plain version

    @property
    def base(self) -> str:
        """The name without its overload (``aten::add``)."""
        return self.name.split(".")[0]

    def host_read(self) -> bool:
        """A read of a device value on the host: a scalar read, or a copy
        from a CUDA device to the CPU."""
        return self.base == HOST_READ or (
            self.base in ("aten::_to_copy", "aten::copy_")
            and "cuda" in self.devices and "cpu" in self.devices)

    def launches(self) -> bool:
        """Whether it launches work on a device (not a view or an
        allocation, not inside the plain version)."""
        return not self.in_step and self.base not in NO_LAUNCH \
            and not self.host_read()

    def key(self) -> tuple:
        """What a round's sequence compares (REP805)."""
        return (self.name, self.dtypes, self.shapes)


@dataclasses.dataclass
class Recording:
    """The operations of one call, in order."""

    ops: list[Op]

    def rounds(self) -> list[list[Op]]:
        """The host's operations between each two photon steps (the
        steady rounds of a round loop), ``in_step`` ones left out."""
        marks = [i for i, op in enumerate(self.ops) if op.name == STEP]
        return [[op for op in self.ops[a + 1:b] if not op.in_step]
                for a, b in zip(marks, marks[1:])]

    def per_round(self) -> dict:
        """Device operations and host reads of each steady round."""
        rounds = self.rounds()
        return {"rounds": len(rounds),
                "device_ops": [1 + sum(op.launches() for op in r)
                               for r in rounds],
                "host_reads": [sum(op.host_read() for op in r)
                               for r in rounds]}


def _tensors(x) -> Iterator:
    import torch

    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _simple(v):
    return v if isinstance(v, (bool, int, float, str, type(None))) else \
        type(v).__name__


class Recorder:
    """Records the aten operations of the calls made inside it; use as a
    context manager, and wrap the photon step with :meth:`step`."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        recorder = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                recorder._add(func.name(), args, kwargs, out)
                return out

        self.ops: list[Op] = []
        self._mode = _Mode()
        self._depth = 0

    def _add(self, name, args, kwargs, out) -> None:
        if self._depth and not name.startswith(IN_STEP_KEPT):
            return  # the plain version's arithmetic: only sums are read
        ins = list(_tensors(args)) + list(_tensors(kwargs))
        outs = list(_tensors(out))
        self.ops.append(Op(
            name=name,
            dtypes=tuple(str(t.dtype) for t in outs),
            shapes=tuple(tuple(t.shape) for t in outs),
            devices=tuple(sorted({t.device.type for t in ins + outs})),
            kwargs=tuple(sorted((k, _simple(v)) for k, v in kwargs.items())),
            bools=tuple(a for a in args if isinstance(a, bool)),
            in_step=self._depth > 0))

    def step(self, fn: Callable) -> Callable:
        """``fn`` (a photon step) recorded as one :data:`STEP` event, its
        own operations flagged ``in_step``."""
        def wrapped(*args, **kwargs):
            self._depth += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                self._depth -= 1
            outs = list(_tensors(out))
            self.ops.append(Op(
                name=STEP, dtypes=tuple(str(t.dtype) for t in outs),
                shapes=tuple(tuple(t.shape) for t in outs),
                devices=tuple(sorted({t.device.type for t in outs})),
                in_step=self._depth > 0))
            return out
        return wrapped

    def __enter__(self) -> "Recorder":
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)

    def recording(self) -> Recording:
        return Recording(list(self.ops))


@contextlib.contextmanager
def stepping_recorded(recorder: Recorder):
    """Route the round loop's and the replay's photon steps through
    ``recorder.step`` for the duration."""
    from repro_torch import replay as R
    from repro_torch.core import simulator as S

    saved = (S.photon_steps, R.photon_steps)
    S.photon_steps = recorder.step(saved[0])
    R.photon_steps = recorder.step(saved[1])
    try:
        yield
    finally:
        S.photon_steps, R.photon_steps = saved


@dataclasses.dataclass
class TraceTarget:
    """One recorded entry point.

    ``make(overrides)`` runs the call and returns its :class:`Recording`;
    ``overrides`` (None for the canonical run) changes its *dynamic*
    arguments (seed, counts, id offsets, media values, source position,
    detector geometry), whose values must not change a round's
    operations.  ``entry`` is the repo-relative file findings anchor to;
    ``variants`` maps a change's name to its overrides (REP805).
    """

    name: str
    entry: str
    make: Callable[[dict | None], Recording]
    variants: dict[str, dict] = dataclasses.field(default_factory=dict)
    _cached: Recording | None = dataclasses.field(default=None, repr=False)

    def recording(self) -> Recording:
        """The canonical run's recording, kept."""
        if self._cached is None:
            self._cached = self.make(None)
        return self._cached


class TracedRule:
    """Base class of the REP8xx rules: ``check(targets)`` over targets
    whose canonical run succeeded (a failure is an REP800 finding)."""

    id: str = "REP800"
    name: str = "traced-base"
    severity: str = "error"
    description: str = ""

    def check(self, targets: list[TraceTarget]) -> Iterator[Finding]:
        return iter(())

    def finding(self, target: TraceTarget, message: str) -> Finding:
        return Finding(rule=self.id, name=self.name, severity=self.severity,
                       path=target.entry, line=1, col=0,
                       message=f"[{target.name}] {message}")


def allowlist_path(root: Path | str) -> Path:
    return Path(root) / ALLOWLIST_NAME


def traced_baseline_path(root: Path | str) -> Path:
    return Path(root) / TRACED_BASELINE_NAME


def load_allowlist(path: Path | str) -> list[dict]:
    """Validated allow entries; empty when the file does not exist.
    Each needs a ``rule``, a non-empty ``why`` and a positive ``max``;
    ``target`` (exact target name) and ``match`` (a substring of the
    message) narrow it."""
    path = Path(path)
    if not path.is_file():
        return []
    data = json.loads(path.read_text())
    if data.get("version") != ALLOWLIST_VERSION:
        raise ValueError(f"{path}: unsupported allow-file version "
                         f"{data.get('version')!r} (this lint reads version "
                         f"{ALLOWLIST_VERSION})")
    entries = data.get("allow", [])
    if not isinstance(entries, list):
        raise ValueError(f"{path}: 'allow' must be a list")
    for i, e in enumerate(entries):
        if not isinstance(e, dict) or not e.get("rule"):
            raise ValueError(f"{path}: allow[{i}] needs a 'rule'")
        if not isinstance(e.get("why"), str) or not e["why"].strip():
            raise ValueError(f"{path}: allow[{i}] ({e.get('rule')}) needs a "
                             f"non-empty 'why'")
        if not isinstance(e.get("max"), int) or e["max"] < 1:
            raise ValueError(f"{path}: allow[{i}] needs a positive int "
                             f"'max'")
    return list(entries)


def _allow_matches(f: Finding, entry: dict) -> bool:
    if entry["rule"] != f.rule:
        return False
    target = entry.get("target")
    if target is not None and not f.message.startswith(f"[{target}]"):
        return False
    match = entry.get("match")
    return match is None or match in f.message


def _traced_fingerprint(f: Finding) -> str:
    return hashlib.sha1(f"{f.rule}:{f.path}:{f.message}".encode()
                        ).hexdigest()[:16]


def run_traced_lint(root: Path | str,
                    targets: Iterable[TraceTarget] | None = None,
                    rules: Iterable[TracedRule] | None = None,
                    rule_ids: Iterable[str] | None = None,
                    baseline: dict[str, int] | None = None,
                    allowlist: list[dict] | None = None) -> LintReport:
    """Record the targets and run the REP8xx rules; the report has the
    AST tier's shape (``suppressed_pragma`` counts what the allow file
    absorbed, ``n_modules`` the targets).  A target whose canonical run
    raises becomes an REP800 finding rather than ending the run."""
    if targets is None:
        from repro_torch.lint.traced.targets import build_default_targets
        targets = build_default_targets()
    targets = list(targets)
    if rules is None:
        from repro_torch.lint.traced.rules import TRACED_RULES
        rules = [r() for r in TRACED_RULES]
    rules = list(rules)
    if rule_ids is not None:
        wanted = set(rule_ids)
        rules = [r for r in rules if r.id in wanted or r.name in wanted]

    raw: list[Finding] = []
    ok: list[TraceTarget] = []
    for t in targets:
        try:
            t.recording()
        except Exception as e:  # a real call of the port: anything goes
            raw.append(Finding(
                rule="REP800", name="trace-failure", severity="error",
                path=t.entry, line=1, col=0,
                message=f"[{t.name}] the call raised "
                        f"{type(e).__name__}: {e}"))
        else:
            ok.append(t)
    for rule in rules:
        raw.extend(rule.check(ok))
    raw.sort(key=lambda f: (f.path, f.rule, f.message))
    live = [dataclasses.replace(f, fingerprint=_traced_fingerprint(f))
            for f in raw]

    n_allow = 0
    if allowlist:
        budgets = [dict(e) for e in allowlist]
        kept = []
        for f in live:
            hit = next((e for e in budgets
                        if _allow_matches(f, e) and e["max"] > 0), None)
            if hit is None:
                kept.append(f)
            else:
                hit["max"] -= 1
                n_allow += 1
        live = kept
    live, n_base = apply_baseline(live, baseline)
    return LintReport(findings=live, suppressed_pragma=n_allow,
                      suppressed_baseline=n_base, n_modules=len(targets),
                      rules_run=[r.id for r in rules])
