"""The versioned on-disk solver cache: schedules, plans, the δ-model.

The counterpart of ``repro.persist.store``.  Layout (one namespace directory
per solver content key, see :mod:`repro_torch.persist.keys`)::

    <cache_dir>/v<CACHE_FORMAT>/<namespace[:16]>/
        meta.json                human-readable key anatomy (debugging only)
        sched_d<δ>_b<L>.npz      DeviceSchedule arrays (host copies)
        plan_d<δ>_b<L>_D<D>.npz  FrontierPlan halo indices per shard count
        delta_model.json         fitted DeltaModel per regime + the δ* served
        observations.jsonl       (δ, rounds, time) of production solves
    <cache_dir>/v<CACHE_FORMAT>/stripes/<digest[:24]>.npz     one worker stripe
    <cache_dir>/v<CACHE_FORMAT>/planshards/<digest[:24]>.npz  one plan shard

``<L>`` is the entry's layout (:func:`~repro_torch.persist.keys.layout_digest`):
a solver keeps its block bounds across ``apply_updates``, so two solvers of
one namespace may hold different bounds, and a whole entry loads only at
its own.

Every write is atomic (a unique tmp file, fsync, ``os.replace``), so a
killed process never leaves a truncated entry; every load is wrapped so a
corrupt, partial or foreign entry is a **miss** (the caller rebuilds cold
and overwrites), never an exception on the solve path and never a wrong
answer.

Derived tensors are never read from disk: a loaded schedule's ``row_ptr``
is derived on the device from its ``dst_local``
(:meth:`~repro_torch.core.engine.DeviceSchedule.from_host_arrays`), and a
loaded plan's ``owned_flat`` and ``dump_last`` from its bounds and
``recv_idx`` (:meth:`~repro_torch.dist.engine_sharded.FrontierPlan.from_host_arrays`).
Only the kernels read them, so a stale copy would pass every plain round.

Left out on purpose: the reference's executable entries
(``save_executable``, ``load_executable``, ``exec_*.bin``, exported
StableHLO).  The port traces nothing; its CUDA kernels are built once a
machine into ``build/kernels/`` under their source's sha256
(:mod:`repro_torch.kernels.build`), which is already a content-addressed
cache.
"""

from __future__ import annotations

import errno
import io
import itertools
import json
import os
import threading
from pathlib import Path

import numpy as np

from repro_torch.core.delta_model import DeltaModel
from repro_torch.core.engine import DeviceSchedule
from repro_torch.ft.inject import fire
from repro_torch.persist import keys

__all__ = ["SolverCache"]

# tmp names are unique per (pid, thread, write): two threads of one process
# must never stage into the same file, or one thread's bytes could land in a
# file the other is about to os.replace — a torn entry under a valid name.
_TMP_COUNTER = itertools.count()
# serializes the observation log's check-compact-append sequence per process
_OBS_LOCK = threading.Lock()


def _atomic_write_bytes(path: Path, data: bytes) -> None:
    """Crash- and race-safe publish: unique tmp + fsync + atomic replace.

    Concurrent writers of one key are last-writer-wins: each stages into its
    own tmp file and publishes with a single ``os.replace``, so a concurrent
    reader sees the old complete entry or the new complete entry, never a
    mix; the fsync before the replace means the rename can never promote
    still-unwritten bytes after a crash.
    """
    kind = fire("persist.write", key=path.name)
    if kind == "eio":
        raise OSError(errno.EIO, f"injected EIO writing {path.name}")
    if kind == "corrupt":  # bit-flip the head: loaders must treat it as a miss
        data = bytes(b ^ 0xFF for b in data[:64]) + data[64:]
    if kind == "torn":  # a kill mid-write: only a prefix reaches the tmp file
        data = data[: max(1, len(data) // 2)]
    tmp = path.with_name(
        f"{path.name}.tmp-{os.getpid()}-{threading.get_ident()}-{next(_TMP_COUNTER)}"
    )
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _read_fault(path: Path) -> None:
    """Chaos hook for the load path; called inside each loader's try block so
    an injected read fault surfaces as a cache miss, never an exception."""
    kind = fire("persist.read", key=path.name)
    if kind is not None:
        raise OSError(errno.EIO, f"injected {kind} fault reading {path.name}")


def _save_npz(path: Path, arrays: dict) -> None:
    """Best-effort atomic ``np.savez``; a full disk degrades, never raises."""
    try:
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        _atomic_write_bytes(path, buf.getbuffer())
    except OSError:
        pass


def _load_npz(path: Path, required: set) -> dict | None:
    """The arrays of ``path`` (all read into memory), or ``None`` on any
    miss: absent, unreadable, torn, foreign, or lacking ``required``."""
    try:
        _read_fault(path)
        with np.load(path, allow_pickle=False) as arrays:
            out = {k: np.asarray(arrays[k]) for k in arrays.files}
    except Exception:
        return None
    return out if required <= out.keys() else None


class SolverCache:
    """One solver's persisted entries under a content-derived namespace.

    Construct via :meth:`for_solver`; all ``load_*`` methods return ``None``
    on any miss, mismatch or corruption, all ``save_*`` methods are atomic
    and best-effort (a full disk degrades to the process-local cache, it
    does not break solving).
    """

    def __init__(self, root, namespace: str, meta: dict | None = None):
        self.root = Path(root)
        self.namespace = namespace
        self.version_dir = self.root / f"v{keys.CACHE_FORMAT}"
        self.dir = self.version_dir / namespace[:16]
        try:
            self.dir.mkdir(parents=True, exist_ok=True)
        except OSError:
            # read-only mount / full disk: every load below misses and every
            # save is a no-op — the solver degrades to its process-local cache
            return
        meta_path = self.dir / "meta.json"
        if meta is not None and not meta_path.exists():
            try:
                _atomic_write_bytes(meta_path, json.dumps(meta, indent=1).encode())
            except OSError:
                pass

    @classmethod
    def for_solver(
        cls,
        root,
        graph,
        problem,
        epilogue,
        n_workers: int,
        partition_method: str,
        min_chunk: int,
        tol: float,
        max_rounds: int,
    ) -> "SolverCache":
        """The namespace for one ``(graph, problem, shape knobs)`` binding.

        ``graph`` must be the *schedule* graph (edge-value overrides applied),
        so e.g. CC's zeroed weights and SSSP's lengths hash differently;
        ``epilogue`` is the problem's row update (at its template query for
        a query problem); ``tol``/``max_rounds`` are the solver's effective
        values.
        """
        graph_fp = keys.graph_fingerprint(graph)
        problem_fp = keys.problem_fingerprint(problem, epilogue)
        ns = keys.solver_namespace(
            graph_fp, problem_fp, n_workers, partition_method, min_chunk, tol, max_rounds
        )
        meta = {
            "env": keys.env_fingerprint(),
            "graph": graph.name,
            "graph_fingerprint": graph_fp[:16],
            "problem": problem.name,
            "problem_fingerprint": problem_fp[:16],
            "n_workers": int(n_workers),
            "partition_method": partition_method,
            "min_chunk": int(min_chunk),
            "tol": float(tol),
            "max_rounds": int(max_rounds),
        }
        return cls(root, ns, meta)

    def _shared(self, kind: str, digest: str) -> Path:
        return self.version_dir / kind / f"{digest[:24]}.npz"

    def _save_shared(self, kind: str, digest: str, arrays: dict) -> None:
        path = self._shared(kind, digest)
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
        except OSError:
            return
        _save_npz(path, arrays)

    # ------------------------------------------------------------------ #
    # stripe schedules
    # ------------------------------------------------------------------ #
    def _sched_path(self, delta: int, bounds) -> Path:
        return self.dir / f"sched_d{int(delta)}_b{keys.layout_digest(bounds)[:16]}.npz"

    def save_schedule(self, arrays: dict) -> None:
        """Persist a schedule's host arrays
        (:meth:`DeviceSchedule.to_host_arrays` or, straight from a build,
        :func:`~repro_torch.core.engine.stripe_schedule_arrays`)."""
        _save_npz(self._sched_path(arrays["delta"], arrays["block_bounds"]), arrays)

    def load_schedule(self, delta: int, bounds, device) -> DeviceSchedule | None:
        """The schedule of ``delta`` at the block ``bounds``, with its tensors
        on ``device`` (``row_ptr`` derived there), or ``None``."""
        arrays = _load_npz(self._sched_path(delta, bounds), {"delta", "block_bounds"})
        if arrays is None:
            return None
        try:
            sched = DeviceSchedule.from_host_arrays(arrays, device)
        except Exception:
            return None
        ok = (
            sched.delta == int(delta)
            and sched.block_bounds is not None
            and np.array_equal(sched.block_bounds, bounds)
        )
        return sched if ok else None

    # ------------------------------------------------------------------ #
    # shared per-worker stripes (content-addressed, cross-namespace)
    # ------------------------------------------------------------------ #
    # Stripes live OUTSIDE the namespace on purpose: a graph mutation changes
    # the namespace (it hashes the whole graph), so per-namespace stripes
    # would never be warm after an update.  The digest alone proves reuse is
    # safe (it hashes the block's own edge content and the environment).

    def save_stripe(self, digest: str, stripe: dict) -> None:
        """Persist one worker stripe under its content digest (atomic)."""
        self._save_shared("stripes", digest, stripe)

    def load_stripe(self, digest: str) -> dict | None:
        """The stripe dict for ``digest`` or ``None`` (corruption ⇒ miss)."""
        return _load_npz(self._shared("stripes", digest), {"src", "val", "dst_local", "rows"})

    # ------------------------------------------------------------------ #
    # shared frontier-plan shard pieces (content-addressed, cross-namespace)
    # ------------------------------------------------------------------ #
    def save_plan_shard(self, digest: str, piece: dict) -> None:
        self._save_shared("planshards", digest, piece)

    def load_plan_shard(self, digest: str) -> dict | None:
        return _load_npz(self._shared("planshards", digest), {"halo", "src_loc", "rows_loc"})

    # ------------------------------------------------------------------ #
    # frontier halo plans
    # ------------------------------------------------------------------ #
    def _plan_path(self, sched: DeviceSchedule, D: int) -> Path:
        layout = keys.layout_digest(sched.block_bounds, sched.M)[:16]
        return self.dir / f"plan_d{int(sched.delta)}_b{layout}_D{int(D)}.npz"

    def save_plan(self, plan, sched: DeviceSchedule) -> None:
        """Persist the halo plan built over ``sched``."""
        _save_npz(self._plan_path(sched, plan.D), plan.to_host_arrays())

    def load_plan(self, sched: DeviceSchedule, D: int):
        """The plan over ``sched`` at ``D`` shards, with its tensors on
        ``sched``'s device (its derived tensors derived there), or ``None``."""
        from repro_torch.dist.engine_sharded import FrontierPlan, plan_shard_bounds

        arrays = _load_npz(self._plan_path(sched, D), {"delta", "D"})
        if arrays is None:
            return None
        try:
            plan = FrontierPlan.from_host_arrays(arrays, sched.device)
            ok = (
                (plan.delta, plan.D, plan.S, plan.n) == (sched.delta, int(D), sched.S, sched.n)
                and plan.P_loc * plan.D == sched.P
                and plan.src_loc.shape[3] == sched.M
                and np.array_equal(plan.vertex_bounds, plan_shard_bounds(sched, D))
            )
        except Exception:
            return None
        return plan if ok else None

    # ------------------------------------------------------------------ #
    # δ-model + production observations
    # ------------------------------------------------------------------ #
    def save_delta_model(self, model: DeltaModel, best_delta: int, regime: str = "cold") -> None:
        """Persist one regime's model, preserving the other regime's section.

        The cold regime keeps the reference's top-level keys; any other
        regime writes ``<regime>_model`` / ``<regime>_best_delta`` beside.
        """
        path = self.dir / "delta_model.json"
        try:
            payload = json.loads(path.read_text())
        except Exception:
            payload = {}
        if regime == "cold":
            payload["best_delta"] = int(best_delta)
            payload["model"] = model.to_dict()
        else:
            payload[f"{regime}_best_delta"] = int(best_delta)
            payload[f"{regime}_model"] = model.to_dict()
        try:
            _atomic_write_bytes(path, json.dumps(payload, indent=1).encode())
        except OSError:
            pass

    def load_delta_model(self, regime: str = "cold") -> tuple[DeltaModel, int] | None:
        """``(model, best_delta)`` for ``regime`` as last fitted, or ``None``."""
        try:
            _read_fault(self.dir / "delta_model.json")
            payload = json.loads((self.dir / "delta_model.json").read_text())
            if regime == "cold":
                model, best = payload["model"], payload["best_delta"]
            else:
                model = payload[f"{regime}_model"]
                best = payload[f"{regime}_best_delta"]
            return DeltaModel.from_dict(model), int(best)
        except Exception:
            return None

    # Compact the observation log once it exceeds this, keeping the newest
    # rows — bounds both the directory and reprobe_delta's refit cost for
    # arbitrarily long-lived services.
    _OBS_MAX_BYTES = 1 << 20
    _OBS_KEEP_ROWS = 4096

    def record_observation(
        self,
        delta: int,
        rounds: int,
        total_time_s: float,
        backend: str,
        kind: str = "solve",
        regime: str = "cold",
    ) -> None:
        """Append one production ``(δ, rounds, time)`` datapoint (JSONL).

        ``regime`` separates cold solves from incremental warm restarts —
        incremental round counts are far lower for the same δ, so mixing the
        regimes in one fit would bias both curves.
        """
        row = {
            "delta": int(delta),
            "rounds": int(rounds),
            "total_time_s": float(total_time_s),
            "backend": backend,
            "kind": kind,
            "regime": regime,
        }
        path = self.dir / "observations.jsonl"
        try:
            # the check-compact-append sequence is not atomic; the lock keeps
            # two in-process writers from interleaving a compaction with an
            # append (cross-process appends stay safe: O_APPEND semantics)
            with _OBS_LOCK:
                if path.exists() and path.stat().st_size > self._OBS_MAX_BYTES:
                    tail = self.load_observations()[-self._OBS_KEEP_ROWS :]
                    _atomic_write_bytes(path, "".join(json.dumps(r) + "\n" for r in tail).encode())
                with open(path, "a") as f:
                    f.write(json.dumps(row) + "\n")
        except OSError:
            pass

    def load_observations(self) -> list[dict]:
        """All readable observation rows (a truncated line is skipped)."""
        out = []
        try:
            text = (self.dir / "observations.jsonl").read_text()
        except OSError:
            return out
        for line in text.splitlines():
            try:
                row = json.loads(line)
                out.append(
                    {
                        "delta": int(row["delta"]),
                        "rounds": int(row["rounds"]),
                        "total_time_s": float(row["total_time_s"]),
                        "backend": row.get("backend", "?"),
                        "kind": row.get("kind", "solve"),
                        "regime": row.get("regime", "cold"),
                    }
                )
            except (ValueError, KeyError, TypeError):
                continue  # partial write from a killed process: skip the line
        return out
