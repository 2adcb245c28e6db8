"""Numerical-health snapshot decoder + report helpers (docs/numerics.md).

The native core streams gradient-health telemetry — per-tensor L2 norm /
absmax / NaN-Inf counts folded into the fusion copy-in, quantization
MSE/SNR accumulated inside the compressed-wire kernels, error-feedback
residual norms, and a cross-rank divergence (SDC) probe — in
``native/gradstats.{h,cpp}``. This module is the Python half:

* :func:`parse_snapshot` — decode one ``hvdtpu_gradstats_snapshot`` /
  ``/gradz`` JSON payload (validates the shape so a truncated scrape fails
  loudly);
* :func:`worst_snr` — the lowest-SNR compressed layer, the readout
  ``hvdrun --top`` surfaces and the first knob-turning signal for
  SNR-guided compression selection (docs/numerics.md walkthrough);
* :func:`format_report` — a human-readable rendering of one rank's
  snapshot (``hvd.grad_report(parsed=False)``);
* :func:`load_profile` / :func:`merge_profile_dir` — the
  ``grad_profile.<rank>.json`` files each job persists at shutdown, merged
  into one ``grad_profile.json`` for the cross-run quality sentry
  (``python -m horovod_tpu_torch.gradstats``).

``GRAD_EVENTS`` / ``NAN_POLICIES`` mirror ``hvdtpu::GradEvent`` /
``hvdtpu::NanPolicy`` byte-for-byte (the ENUM-MIRROR rule of the JAX
package's invariant linter): the NanPolicy code rides the NONFINITE flight
record's arg word across the C++/Python boundary.

The port's own copy of ``horovod_tpu/gradstats.py`` (it imports nothing of
the JAX package); the two are held to the same outputs on the same input
(``tests/test_torch_port_observability.py``).
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Tuple

# Byte-for-byte mirror of hvdtpu::GradEvent (native/gradstats.h).
GRAD_EVENTS = {"nonfinite": 0, "divergence": 1, "residual_reset": 2}
GRAD_EVENT_NAMES = {v: k for k, v in GRAD_EVENTS.items()}

# Byte-for-byte mirror of hvdtpu::NanPolicy (native/gradstats.h); the
# accepted HVDTPU_NANCHECK vocabulary.
NAN_POLICIES = {"off": 0, "warn": 1, "abort": 2}
NAN_POLICY_NAMES = {v: k for k, v in NAN_POLICIES.items()}


def parse_snapshot(data) -> dict:
    """Decode one gradstats snapshot (bytes/str JSON) into a dict, with
    shape validation — a truncated or non-gradz payload raises
    ``ValueError`` instead of surfacing as weird KeyErrors downstream."""
    if isinstance(data, bytes):
        data = data.decode()
    try:
        snap = json.loads(data)
    except json.JSONDecodeError as exc:
        raise ValueError(f"not a gradstats snapshot: {exc}") from exc
    if not isinstance(snap, dict) or "keys" not in snap or \
            snap.get("version") != 1:
        raise ValueError("not a gradstats snapshot (missing version/keys)")
    for entry in snap["keys"]:
        for field in ("key", "count", "norm", "ewma_norm", "absmax",
                      "nonfinite", "quant_count"):
            if field not in entry:
                raise ValueError(
                    f"malformed gradstats key entry: missing {field!r}")
        if entry["quant_count"] > 0 and "snr_db" not in entry:
            raise ValueError(
                "malformed gradstats key entry: quantized key without SNR")
    return snap


def worst_snr(snap: dict) -> Optional[dict]:
    """The compressed key with the lowest EWMA SNR — the layer quantization
    hurts most, and the first candidate for the skip-regex or a wider code
    (docs/numerics.md "SNR-guided compression selection"). None when no key
    has been quantized yet."""
    best = None
    for entry in snap.get("keys", []):
        if entry.get("quant_count", 0) <= 0:
            continue
        snr = float(entry.get("ewma_snr_db", entry.get("snr_db", 0.0)))
        if best is None or snr < best["snr_db"]:
            best = {"key": entry["key"], "snr_db": snr,
                    "compression": entry.get("compression", "?"),
                    "mse": float(entry.get("mse", 0.0)),
                    "residual_norm": float(entry.get("residual_norm", 0.0))}
    return best


def format_report(snap: dict, top: int = 10) -> str:
    """Human-readable rendering of one rank's snapshot: the ``top`` keys by
    gradient norm, their health fields, and the probe/sentinel totals."""
    lines = ["gradient health (per tensor-set; docs/numerics.md):"]
    entries = sorted(snap.get("keys", []),
                     key=lambda e: float(e.get("ewma_norm", 0.0)),
                     reverse=True)
    header = (f"  {'key':<40} {'count':>7} {'norm':>10} {'ewma':>10} "
              f"{'absmax':>9} {'nan':>5} {'comp':>5} {'snr dB':>7} "
              f"{'res':>9}")
    lines.append(header)
    for e in entries[:top]:
        quant = e.get("quant_count", 0) > 0
        lines.append(
            f"  {e['key'][:40]:<40} {e['count']:>7} "
            f"{float(e['norm']):>10.4g} {float(e['ewma_norm']):>10.4g} "
            f"{float(e['absmax']):>9.3g} {e['nonfinite']:>5} "
            f"{e.get('compression', '-') if quant else '-':>5} "
            f"{float(e['ewma_snr_db']) if quant else float('nan'):>7.1f} "
            f"{float(e.get('residual_norm', 0.0)) if quant else 0.0:>9.3g}")
    if len(entries) > top:
        lines.append(f"  ... {len(entries) - top} more key(s)")
    worst = worst_snr(snap)
    if worst is not None:
        lines.append(
            f"  worst SNR: {worst['key']} at {worst['snr_db']:.1f} dB "
            f"({worst['compression']}, residual norm "
            f"{worst['residual_norm']:.3g})")
    lines.append(
        f"  nancheck={snap.get('nancheck', '?')} "
        f"nonfinite={snap.get('nonfinite_total', 0)} "
        f"probes={snap.get('probes_total', 0)} "
        f"divergence={snap.get('divergence_total', 0)} "
        f"residual_resets={snap.get('residual_resets_total', 0)}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Cross-run profiles (grad_profile.<rank>.json -> grad_profile.json)
# ---------------------------------------------------------------------------

_PROFILE_FILE_RE = re.compile(r"^grad_profile\.(\d+)\.json$")


def load_profile(path: str) -> dict:
    """One profile file — either a per-rank ``grad_profile.<rank>.json``
    (native format: {"version", "rank", "size", "gradstats"}) or a merged
    ``grad_profile.json`` ({"version", "ranks": {...}})."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or doc.get("version") != 1:
        raise ValueError(f"{path}: not a grad profile (version != 1)")
    return doc


def profile_ranks(doc: dict) -> Dict[int, dict]:
    """Normalize a profile document into {rank: per-rank profile}."""
    if "ranks" in doc:
        return {int(r): p for r, p in doc["ranks"].items()}
    return {int(doc.get("rank", 0)): doc}


def merge_profile_dir(path: str) -> Tuple[dict, List[int]]:
    """Merge every ``grad_profile.<rank>.json`` under ``path`` into one
    document; returns (merged, ranks found). Unparseable files are skipped
    (a rank that died mid-write must not take the merge down)."""
    ranks: Dict[str, dict] = {}
    found: List[int] = []
    for name in sorted(os.listdir(path)):
        m = _PROFILE_FILE_RE.match(name)
        if m is None:
            continue
        try:
            ranks[m.group(1)] = load_profile(os.path.join(path, name))
        except (ValueError, OSError, json.JSONDecodeError):
            continue
        found.append(int(m.group(1)))
    return {"version": 1, "ranks": ranks}, found


# ---------------------------------------------------------------------------
# the cross-run quality sentry (CLI)
# ---------------------------------------------------------------------------

def load_any(path: str) -> dict:
    """Profile file OR directory of grad_profile.<rank>.json files."""
    if os.path.isdir(path):
        merged, found = merge_profile_dir(path)
        if not found:
            raise ValueError(f"{path}: no grad_profile.<rank>.json files")
        return merged
    return load_profile(path)


def key_entries(doc: dict) -> Dict[Tuple[int, str], dict]:
    """{(rank, key): key-entry} across every rank in a profile document."""
    out: Dict[Tuple[int, str], dict] = {}
    for rank, prof in profile_ranks(doc).items():
        snap = prof.get("gradstats", {})
        for entry in snap.get("keys", []):
            out[(rank, entry["key"])] = entry
    return out


def totals(doc: dict) -> Dict[str, float]:
    agg = {"nonfinite_total": 0.0, "divergence_total": 0.0,
           "residual_resets_total": 0.0}
    for prof in profile_ranks(doc).values():
        snap = prof.get("gradstats", {})
        for k in agg:
            agg[k] += float(snap.get(k, 0))
    return agg


def main(argv: Optional[List[str]] = None) -> int:
    """The cross-run numerical-quality sentry (counterpart of the JAX
    package's ``scripts/grad_diff.py``)::

        python -m horovod_tpu_torch.gradstats OLD NEW [--snr-threshold-db 3]

    OLD and NEW each name a merged ``grad_profile.json``, a per-rank file
    or a directory of per-rank files. Flags a compressed key whose EWMA SNR
    dropped by more than the threshold and non-finite gradients or
    divergence convictions new in NEW. Exit status: 0 no regression, 1 a
    quality regression, 2 unreadable profiles."""
    import argparse
    import sys
    ap = argparse.ArgumentParser(
        description="Cross-run numerical-quality sentry")
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--snr-threshold-db", type=float, default=3.0,
                    help="flag a compressed key whose EWMA SNR dropped by "
                         "more than this many dB (default 3)")
    ap.add_argument("--min-quant-ops", type=int, default=3,
                    help="compare a key's SNR only when both runs "
                         "quantized it at least this many times")
    args = ap.parse_args(argv)
    try:
        old_doc = load_any(args.old)
        new_doc = load_any(args.new)
    except (OSError, ValueError) as exc:
        print(f"grad_diff: {exc}", file=sys.stderr)
        return 2

    old_keys = key_entries(old_doc)
    new_keys = key_entries(new_doc)
    regressions: List[str] = []
    compared = 0
    for ident in sorted(set(old_keys) & set(new_keys)):
        o, nw = old_keys[ident], new_keys[ident]
        if min(o.get("quant_count", 0),
               nw.get("quant_count", 0)) < args.min_quant_ops:
            continue
        compared += 1
        rank, key = ident
        o_snr = float(o.get("ewma_snr_db", 0.0))
        n_snr = float(nw.get("ewma_snr_db", 0.0))
        drop = o_snr - n_snr
        line = (f"  rank {rank} {key}: SNR {o_snr:.1f} -> {n_snr:.1f} dB "
                f"({o.get('compression', '?')} -> "
                f"{nw.get('compression', '?')})")
        if drop > args.snr_threshold_db:
            regressions.append(line + f"  [REGRESSED {drop:.1f} dB]")
        else:
            print(line)
    old_t, new_t = totals(old_doc), totals(new_doc)
    for field, label in (("nonfinite_total", "NaN/Inf gradient elements"),
                         ("divergence_total", "divergence convictions")):
        if new_t[field] > 0 and old_t[field] == 0:
            regressions.append(
                f"  {label}: 0 -> {new_t[field]:.0f}  [NEW in this run]")
    if new_t["residual_resets_total"] > old_t["residual_resets_total"]:
        print(f"  note: residual resets {old_t['residual_resets_total']:.0f}"
              f" -> {new_t['residual_resets_total']:.0f} (fusion churn?)")

    print(f"grad_diff: compared {compared} compressed key(s)")
    if regressions:
        print("grad_diff: QUALITY REGRESSION:", file=sys.stderr)
        for line in regressions:
            print(line, file=sys.stderr)
        return 1
    print("grad_diff: no quality regression")
    return 0



if __name__ == "__main__":
    import sys
    sys.exit(main())
