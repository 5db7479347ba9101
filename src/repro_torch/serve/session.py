"""SolveSession — one spectral job inside its own store namespace (port of
`repro.serve.session`).

A session owns nothing global: its subspace blocks, its streamed matrix
image and its checkpoints all live under `store.namespace(job_id)` on the
*shared* TieredStore/SafsBackend, its device bytes are whatever the
`BudgetArbiter` allotted, and its lifecycle is driven by the scheduler:

    PENDING ──run()──► RUNNING ──► DONE | FAILED
                          │  ▲
           guard fires →  ▼  │ rerun (resume=ckpt_root)
                       SUSPENDED

Preemption composes the checkpoint layer (`repro_torch.ckpt.solver`): the
scheduler raises the session's
`PreemptFlag`; the solve's `CheckpointPolicy(guard=flag)` finishes the
in-flight restart, commits a snapshot, and raises `SolveSuspended`; the
scheduler then drops the namespace (freeing the allotment for the job that
preempted it) and requeues the session, whose next `run()` resumes from the
committed checkpoint — a bit-identical continuation, so preempted spectra
match uninterrupted ones exactly.

The problem itself (graph + operator) is rebuilt deterministically from the
JobSpec seed on every run — only the solver state crosses a suspension,
exactly like the SIGTERM path in `examples/ooc_lanczos.py`.

On the card the session runs the hand-written kernels: the operator takes
the namespace's device and the solve runs with `impl="auto"`, so a CUDA
store launches the SpMM, gram and tsgemm kernels and a CPU store takes
their plain versions. (The reference forces `impl="ref"`, its plain JAX
path.) A cluster job's embedding crosses to numpy with `.cpu()`; the
eigenvalues and residuals of the port's `EigResult` are numpy already.

Corruption rides the same suspend edge: a typed `CorruptPageError` /
`CorruptSnapshotError` mid-solve moves the session to SUSPENDED (up to
`JobSpec.max_corruption_retries` times, traced
`serve.corruption_recovery`); the scheduler drops the namespace — the
corrupt pages die with it — and the requeued run resumes from the last
good checkpoint. Budget exhausted, or no checkpoint root: FAILED with
the typed error.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.ckpt.checkpoint import CorruptSnapshotError
from repro_torch.ckpt.solver import CheckpointPolicy, SolveSuspended
from repro_torch.core import GraphOperator, solve
from repro_torch.graphs import normalized_adjacency, pack_tiles, rmat_graph
from repro_torch.obs import trace
from repro_torch.obs.progress import ConvergenceTracker
from repro_torch.safs.faults import CorruptPageError

PENDING = "pending"
RUNNING = "running"
SUSPENDED = "suspended"
DONE = "done"
FAILED = "failed"

KINDS = ("eigsh", "lobpcg", "cluster")
GRAPHS = ("rmat", "planted")


class PreemptFlag:
    """The scheduler's suspend signal, duck-compatible with
    `ft.PreemptionGuard` (`CheckpointPolicy.guard` only needs
    `requested()`): raise with `request()`, the solve checkpoints at its
    next restart boundary and raises `SolveSuspended`."""

    def __init__(self):
        self._event = threading.Event()

    def request(self) -> None:
        self._event.set()

    def clear(self) -> None:
        self._event.clear()

    def requested(self) -> bool:
        return self._event.is_set()


@dataclasses.dataclass
class JobSpec:
    """One spectral job: what to solve, on which synthetic graph, at what
    priority. `kind` picks the workload — "eigsh" (Krylov–Schur embedding),
    "lobpcg" (same spectrum via the LOBPCG family member), "cluster"
    (spectral clustering: embed + spherical k-means + purity against the
    planted partition)."""
    job_id: str
    kind: str = "eigsh"
    graph: str = "rmat"            # "planted" forced for kind="cluster"
    n: int = 1200
    nnz: int = 12000               # rmat edge target
    k_classes: int = 4             # planted partition communities
    nev: int = 4
    priority: int = 0
    tol: float = 1e-6
    max_iters: int = 80
    block_size: Optional[int] = None
    which: str = "LA"              # normalized adjacency: largest algebraic
    seed: int = 0
    stream_image: bool = False     # spill the matrix image into the store
    preemptible: bool = True
    checkpoint_every: int = 0      # 0 = preemption-triggered snapshots only
    deadline_s: Optional[float] = None   # job wall-clock budget (watchdog)
    # corruption-recovery budget: how many times a CorruptPageError may be
    # answered by abandoning the namespace and resuming from the newest
    # VERIFIED checkpoint before the job fails typed
    max_corruption_retries: int = 1
    options: Dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"job {self.job_id!r}: unknown kind "
                             f"{self.kind!r} (one of {KINDS})")
        if self.kind == "cluster":
            self.graph = "planted"
        if self.graph not in GRAPHS:
            raise ValueError(f"job {self.job_id!r}: unknown graph "
                             f"{self.graph!r} (one of {GRAPHS})")

    @property
    def method(self) -> str:
        return "lobpcg" if self.kind == "lobpcg" else "krylov_schur"

    @classmethod
    def from_dict(cls, d: dict) -> "JobSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown job-spec fields: {sorted(unknown)}")
        if "job_id" not in d:
            raise ValueError("job spec needs a job_id")
        return cls(**d)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


# ------------------------------------------------------------ problem build
def planted_partition(n: int, k: int, d_avg: int = 12, p_in: float = 0.85,
                      seed: int = 0):
    """Planted-partition COO graph + ground-truth labels (the clustering
    workload's dataset; mirrors examples/spectral_cluster.py, and pads the
    labels with the last class when k does not divide n). The same draws
    as the reference's, so both packages build the same graph from a
    seed."""
    rng = np.random.default_rng(seed)
    labels = np.repeat(np.arange(k), n // k)
    labels = np.concatenate([labels,
                             np.full(n - labels.size, k - 1, labels.dtype)])
    rows, cols = [], []
    for i in range(n):
        for _ in range(d_avg):
            j = int(rng.integers(0, n))
            p = p_in if labels[i] == labels[j] else (1 - p_in) / (k - 1)
            if rng.random() < p and i != j:
                rows.append(i)
                cols.append(j)
    r = np.array(rows + cols, np.int32)
    c = np.array(cols + rows, np.int32)
    key = r.astype(np.int64) * n + c
    _, idx = np.unique(key, return_index=True)
    return labels, r[idx], c[idx], np.ones(idx.size, np.float32)


def spherical_kmeans_purity(emb: np.ndarray, labels: np.ndarray,
                            k: int, iters: int = 30) -> float:
    """Cluster rows of `emb` on the unit sphere (deterministic linspace
    init) and score purity against the planted labels."""
    n = emb.shape[0]
    emb = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-12)
    cents = emb[np.linspace(0, n - 1, k).astype(int)]
    assign = np.zeros(n, np.int64)
    for _ in range(iters):
        assign = np.argmax(emb @ cents.T, axis=1)
        cents = np.stack([emb[assign == i].mean(0) if (assign == i).any()
                          else cents[i] for i in range(k)])
        cents /= np.linalg.norm(cents, axis=1, keepdims=True) + 1e-12
    return float(sum(np.bincount(labels[assign == i]).max()
                     for i in range(k) if (assign == i).any()) / n)


def build_problem(spec: JobSpec, store):
    """Deterministically rebuild the job's operator inside `store` (a
    session namespace). Returns (op, labels) — labels only for the planted
    graph. Determinism matters twice: a resumed session must reconstruct
    the *same* matrix, and the serial-parity test reruns the same spec."""
    if spec.graph == "planted":
        labels, r, c, v = planted_partition(spec.n, spec.k_classes,
                                            seed=spec.seed)
    else:
        labels = None
        r, c, v = rmat_graph(spec.n, spec.nnz, seed=spec.seed,
                             symmetric=True)
    r2, c2, v2 = normalized_adjacency(spec.n, r, c, v)
    image = pack_tiles(spec.n, spec.n, r2, c2, v2, block_shape=(64, 64),
                       min_block_nnz=4)
    # the operator lives on the namespace's device; "auto" launches the
    # kernels there when it is the card
    op = GraphOperator(image, store=store, impl="auto",
                       stream_image=spec.stream_image, name="A")
    return op, labels


# ----------------------------------------------------------------- session
class SolveSession:
    """One job's full lifecycle over the shared store (see module doc)."""

    def __init__(self, spec: JobSpec, store, ckpt_root: Optional[str]):
        self.spec = spec
        self.store = store                      # the PARENT TieredStore
        self.ckpt_root = (os.path.join(ckpt_root, spec.job_id)
                          if ckpt_root else None)
        self.state = PENDING
        self.guard = PreemptFlag()
        self.tracker = ConvergenceTracker(tol=spec.tol, nev=spec.nev,
                                          method=spec.method)
        self.result: Optional[dict] = None
        self.error: Optional[str] = None
        self.purity: Optional[float] = None
        self.preemptions = 0
        self.corruption_recoveries = 0
        self._resume_next = False      # next run() resumes from ckpt_root
        self.resumes = 0
        self.segments = 0              # run() invocations (1 + resumes)
        self.wall_s = 0.0              # solving time, summed over segments
        self.queue_wait_s = 0.0        # time spent PENDING, summed
        self._queued_at: Optional[float] = None

    # ------------------------------------------------------- queue timing
    def mark_queued(self) -> None:
        self._queued_at = time.monotonic()

    def mark_dequeued(self) -> None:
        if self._queued_at is not None:
            self.queue_wait_s += time.monotonic() - self._queued_at
            self._queued_at = None

    @property
    def can_preempt(self) -> bool:
        """Preemption needs a checkpoint root to suspend into and a
        checkpoint-capable method (both family members here qualify)."""
        return (self.spec.preemptible and self.ckpt_root is not None
                and self.state == RUNNING and not self.guard.requested())

    # ------------------------------------------------------------- worker
    def run(self) -> str:
        """Execute (or resume) the solve on the calling thread; returns
        the terminal state of this segment (DONE/SUSPENDED/FAILED)."""
        t0 = time.monotonic()
        self.state = RUNNING
        self.guard.clear()
        self.segments += 1
        resume = self.ckpt_root if self._resume_next else None
        if resume is not None:
            self.resumes += 1
        spec = self.spec
        try:
            ns = self.store.namespace(spec.job_id)
            op, labels = build_problem(spec, ns)
            checkpoint = None
            if self.ckpt_root is not None:
                checkpoint = CheckpointPolicy(
                    root=self.ckpt_root,
                    every_restarts=spec.checkpoint_every,
                    keep=2, guard=self.guard)
            block = spec.block_size or (2 * spec.nev
                                        if spec.method == "lobpcg"
                                        else spec.nev)
            res = solve(op, spec.nev, method=spec.method, which=spec.which,
                        tol=spec.tol, max_iters=spec.max_iters,
                        block_size=block, store=ns, impl="auto",
                        seed=spec.seed, callback=self.tracker.chain(),
                        checkpoint=checkpoint, resume=resume,
                        **spec.options)
            self.result = {
                "eigenvalues": np.sort(np.asarray(res.eigenvalues,
                                                  np.float64)).tolist(),
                "residuals": np.asarray(res.residuals,
                                        np.float64).tolist(),
                "converged": bool(res.converged),
                "n_restarts": int(res.n_restarts),
                "resumed_step": res.resumed_step,
                "io_stats": res.io_stats,
            }
            if spec.kind == "cluster" and res.eigenvectors is not None:
                emb = res.eigenvectors[:spec.n].cpu().numpy()
                self.purity = spherical_kmeans_purity(
                    emb, labels, spec.k_classes)
            self.state = DONE
        except SolveSuspended:
            self.preemptions += 1
            self._resume_next = True
            self.state = SUSPENDED
        except (CorruptPageError, CorruptSnapshotError) as e:
            # Corruption recovery: the detection already guaranteed no
            # rotten bytes were served. If the retry budget allows, exit
            # SUSPENDED — the scheduler abandons this namespace (its
            # corrupt pages die with it) and requeues us; the next run()
            # resumes from the newest checkpoint that VERIFIES (the
            # resume path skips corrupt/torn snapshots), or from scratch
            # when none does. Budget exhausted → typed failure.
            if (self.ckpt_root is not None
                    and self.corruption_recoveries
                    < spec.max_corruption_retries):
                self.corruption_recoveries += 1
                self._resume_next = True
                trace.event("serve.corruption_recovery", job=spec.job_id,
                            attempt=self.corruption_recoveries,
                            error=f"{type(e).__name__}: {e}")
                self.state = SUSPENDED
            else:
                self.error = f"{type(e).__name__}: {e}"
                self.state = FAILED
        except Exception as e:            # captured into the serve report
            self.error = f"{type(e).__name__}: {e}"
            self.state = FAILED
        finally:
            self.wall_s += time.monotonic() - t0
        return self.state

    # ------------------------------------------------------------ surface
    def progress(self) -> dict:
        """Live progress for the scheduler's gauges: step count, worst
        relative residual, and the ConvergenceTracker ETA."""
        hist = self.tracker.history
        last = hist[-1][1] if hist else None
        return {
            "state": self.state,
            "priority": self.spec.priority,
            "steps": len(hist),
            "res_max_rel": (None if last is None or not np.isfinite(last)
                            else float(last)),
            "eta_steps": self.tracker.eta_steps(),
            "preemptions": self.preemptions,
            "corruption_recoveries": self.corruption_recoveries,
            "segments": self.segments,
        }

    def report(self) -> dict:
        """The per-job block of the machine-readable serve report."""
        return {
            "job_id": self.spec.job_id,
            "kind": self.spec.kind,
            "method": self.spec.method,
            "priority": self.spec.priority,
            "state": self.state,
            "wall_s": self.wall_s,
            "queue_wait_s": self.queue_wait_s,
            "preemptions": self.preemptions,
            "corruption_recoveries": self.corruption_recoveries,
            "resumes": self.resumes,
            "segments": self.segments,
            "purity": self.purity,
            "error": self.error,
            "result": self.result,
            "spectrum": spectrum_digest(
                self.result["eigenvalues"]) if self.result else None,
        }


def spectrum_digest(eigenvalues: List[float]) -> dict:
    """Stable digest of a spectrum for cross-run comparison: the sorted
    eigenvalues rounded to 1e-8 plus a hash of those rounded bytes."""
    import hashlib
    vals = np.sort(np.asarray(eigenvalues, np.float64))
    rounded = np.round(vals, 8)
    h = hashlib.sha256(rounded.tobytes()).hexdigest()[:16]
    return {"nev": int(vals.size), "values": rounded.tolist(), "sha": h}
