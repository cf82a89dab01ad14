"""Six-metric numerics-parity gates.

The same error metrics and default tolerance gates as the JAX package's
``utils/metrics.py``, on numpy arrays and torch tensors: the port is held to
the same parity contract against the same kind of fp32 oracle.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

# Failure forensics: set FAT_FAIL_DUMP=<dir> to write the worst elements and
# the metrics of any failed parity gate there.
FAIL_DUMP_ENV = "FAT_FAIL_DUMP"
FAIL_DUMP_TOPK = 1000

# The reference's backward-pass tolerance gates; max_rel and l2 are
# effectively informational (rtol=1000, 100).
DEFAULT_TOLS = {
    "atol": 5e-3,
    "mean_atol": 2e-4,
    "rtol": 1000.0,
    "mean_rtol": 1e-2,
    "rtol_l2": 100.0,
}


@dataclasses.dataclass(frozen=True)
class ErrorMetrics:
    max_abs: float
    mean_abs: float
    max_rel: float
    mean_rel: float
    l2_rel: float
    rms_rel: float

    def __str__(self) -> str:
        return (
            f"max_abs={self.max_abs:.3e} mean_abs={self.mean_abs:.3e} "
            f"max_rel={self.max_rel:.3e} mean_rel={self.mean_rel:.3e} "
            f"l2_rel={self.l2_rel:.3e} rms_rel={self.rms_rel:.3e}"
        )


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(x, np.float32)


# elements a card-side pass promotes to fp32 at a time
_CHUNK = 1 << 26


def _card_of(test, ref):
    """The CUDA device of a pair of torch tensors of which one lies on a
    card, else None. Such a pair is measured on that card: copying a
    tensor of hundreds of millions of elements to the host and reducing it
    in numpy takes seconds."""
    if isinstance(test, torch.Tensor) and isinstance(ref, torch.Tensor):
        return next((x.device for x in (test, ref) if x.is_cuda), None)
    return None


def _error_metrics_on(dev, test, ref, eps: float) -> ErrorMetrics:
    """:func:`error_metrics` on the card ``dev``: fp32 elements, a chunk at
    a time, with the sums in fp64."""
    assert test.shape == ref.shape, \
        f"shape mismatch {tuple(test.shape)} vs {tuple(ref.shape)}"
    t, r = test.detach().reshape(-1), ref.detach().reshape(-1)
    n = t.numel()
    if not n:
        return ErrorMetrics(0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
    # max |d|, sum |d|, max |d| / (|r| + eps), its sum, sum d^2, sum r^2
    acc = torch.zeros(6, dtype=torch.float64, device=dev)
    for i in range(0, n, _CHUNK):
        tc = t[i:i + _CHUNK].to(dev, torch.float32)
        rc = r[i:i + _CHUNK].to(dev, torch.float32)
        d = (tc - rc).abs_()
        rel = d / rc.abs().add_(eps)
        acc = torch.stack([
            torch.maximum(acc[0], d.max().double()),
            acc[1] + d.sum(dtype=torch.float64),
            torch.maximum(acc[2], rel.max().double()),
            acc[3] + rel.sum(dtype=torch.float64),
            acc[4] + d.square().sum(dtype=torch.float64),
            acc[5] + rc.square().sum(dtype=torch.float64)])
    max_abs, sum_abs, max_rel, sum_rel, ss_d, ss_r = acc.tolist()
    return ErrorMetrics(
        max_abs=max_abs, mean_abs=sum_abs / n, max_rel=max_rel,
        mean_rel=sum_rel / n, l2_rel=ss_d**0.5 / (ss_r**0.5 + eps),
        rms_rel=(ss_d / n)**0.5 / ((ss_r / n)**0.5 + eps))


def error_metrics(test, ref, eps: float = 1e-6) -> ErrorMetrics:
    """The 6 error metrics of test vs ref (both promoted to fp32)."""
    dev = _card_of(test, ref)
    if dev is not None:
        return _error_metrics_on(dev, test, ref, eps)
    t, r = _f32(test), _f32(ref)
    assert t.shape == r.shape, f"shape mismatch {t.shape} vs {r.shape}"
    diff = np.abs(t - r)
    denom = np.abs(r) + eps
    l2_ref = float(np.linalg.norm(r))
    l2_diff = float(np.linalg.norm(diff))
    rms_ref = float(np.sqrt(np.mean(r**2))) if r.size else 0.0
    rms_diff = float(np.sqrt(np.mean(diff**2))) if diff.size else 0.0
    return ErrorMetrics(
        max_abs=float(diff.max()) if diff.size else 0.0,
        mean_abs=float(diff.mean()) if diff.size else 0.0,
        max_rel=float((diff / denom).max()) if diff.size else 0.0,
        mean_rel=float((diff / denom).mean()) if diff.size else 0.0,
        l2_rel=l2_diff / (l2_ref + eps),
        rms_rel=rms_diff / (rms_ref + eps),
    )


def assert_metrics(name: str, test, ref, tols: dict | None = None,
                   aux: dict | None = None) -> ErrorMetrics:
    """Assert the tolerance gates on (test, ref); return the metrics.

    Non-finite values fail first: every threshold compare is False for NaN,
    so without that check a tensor of NaNs would pass every gate. ``aux``:
    optional named arrays (the LSE beside gradient gates, say) written into
    the failure dump (``FAT_FAIL_DUMP``)."""
    tols = {**DEFAULT_TOLS, **(tols or {})}
    m = error_metrics(test, ref)
    failures = []
    if _card_of(test, ref) is not None:
        n_bad = int(torch.isfinite(test.detach()).logical_not().sum())
    else:
        n_bad = int(np.count_nonzero(~np.isfinite(_f32(test))))
    if n_bad:
        failures.append(f"{n_bad} non-finite value(s) in output")
    if m.max_abs > tols["atol"]:
        failures.append(f"max_abs {m.max_abs:.3e} > atol {tols['atol']:.1e}")
    if m.mean_abs > tols["mean_atol"]:
        failures.append(f"mean_abs {m.mean_abs:.3e} > mean_atol {tols['mean_atol']:.1e}")
    if m.max_rel > tols["rtol"]:
        failures.append(f"max_rel {m.max_rel:.3e} > rtol {tols['rtol']:.1e}")
    if m.mean_rel > tols["mean_rtol"]:
        failures.append(f"mean_rel {m.mean_rel:.3e} > mean_rtol {tols['mean_rtol']:.1e}")
    if m.l2_rel > tols["rtol_l2"]:
        failures.append(f"l2_rel {m.l2_rel:.3e} > rtol_l2 {tols['rtol_l2']:.1e}")
    if failures and os.environ.get(FAIL_DUMP_ENV):
        _dump_failure(os.environ[FAIL_DUMP_ENV], name, test, ref, m, failures,
                      aux=aux)
    assert not failures, f"[{name}] parity gate failed: {'; '.join(failures)} ({m})"
    return m


def _dump_failure(dump_dir: str, name: str, test, ref, m: ErrorMetrics,
                  failures: list[str], topk: int = FAIL_DUMP_TOPK,
                  aux: dict | None = None) -> None:
    """Write the worst elements by absolute and relative error and the
    metric summary (CSV and JSON), and any ``aux`` arrays as an .npz."""
    os.makedirs(dump_dir, exist_ok=True)
    t, r = _f32(test), _f32(ref)
    diff = np.abs(t - r)
    rel = diff / (np.abs(r) + 1e-6)
    tag = "".join(c if c.isalnum() else "_" for c in name)
    base = os.path.join(dump_dir, f"fail_{tag}_{int(time.time() * 1000)}")
    with open(base + ".json", "w") as f:
        json.dump({"name": name, "failures": failures,
                   "metrics": dataclasses.asdict(m),
                   "shape": list(t.shape)}, f, indent=2)
    if aux:
        np.savez(base + "_aux.npz",
                 **{k: _f32(v) for k, v in aux.items() if v is not None})
    with open(base + ".csv", "w") as f:
        f.write("rank,kind,index,test,ref,abs_err,rel_err\n")
        for kind, score in (("abs", diff), ("rel", rel)):
            flat = score.ravel()
            k = min(topk, flat.size)
            if k == 0:
                continue
            worst = np.argpartition(flat, -k)[-k:]
            worst = worst[np.argsort(-flat[worst])]
            for rank, idx in enumerate(worst):
                mi = np.unravel_index(idx, t.shape)
                f.write(f"{rank},{kind},\"{mi}\",{t[mi]:.6e},{r[mi]:.6e},"
                        f"{diff[mi]:.6e},{rel[mi]:.6e}\n")
