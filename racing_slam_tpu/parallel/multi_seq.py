"""Data-parallel multi-sequence tracking over a (possibly multi-host) mesh.

The reference processes exactly one video in one thread (src/main.cpp:72-111).
The multi-device deployment shape is a fleet: S independent sequences tracked
concurrently, each owning its own SlamState, sharded over the mesh's 'seq'
axis — pure data parallelism with zero cross-sequence communication (XLA
inserts none: every collective-free op is elementwise in the seq axis).
Combined with landmark-sharded bundle adjustment (parallel/dist_ba.py, 'lm'
axis) this gives the 2-D scale-out mesh: seq x lm.

Design notes:
- The per-sequence program is the SAME fused step the single-chip engine runs
  (slam.pipeline.slam_step_batch); vmap lifts it over the sequence axis,
  shard_map runs it per device on that device's block of sequences, and
  NamedSharding('seq') places each sequence's state/frames on its device.
  shard_map (rather than leaving the split to the SPMD partitioner) keeps
  the Pallas kernels of the step, which the partitioner cannot split,
  local to each device.
  Under vmap, lax.cond lowers to select (both branches execute) — the price
  of lockstep SPMD tracking; keyframe commits are a minority of frames, and
  all sequences share one compiled program.
- Host side, each sequence keeps its own video decoder; frames are stacked
  [S_local, N, H, W] and assembled with the sequence sharding
  (mesh.put_sharded), so each chip only receives its own sequences' bytes.

Multi-host operation (jax.distributed, parallel/mesh.initialize_distributed):
every process constructs MultiSlam with ONLY ITS OWN sequences' videos; the
global sequence count is S_local summed over processes, and process p's j-th
video maps to the j-th global row whose 'seq' shard lives on p's devices
(`local_rows`). All processes run run_batched in lockstep (the jitted step is
one SPMD program over the global mesh); control decisions — how many frames
this batch, which sequences are lost — are made identically everywhere by
allgathering the tiny per-sequence scalars, while pixel/state data never
crosses hosts outside the jitted collectives. Loss recovery pulls only the
ADDRESSABLE shards to the owning host, re-bootstraps there, and reassembles
the global array from process-local rows.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.camera import Camera
from ..slam.config import SlamConfig
from ..slam.pipeline import slam_step_batch
from ..slam.state import SlamState
from .mesh import put_sharded


def batched_state(
    S: int, F: int, Pcap: int, O: int, K: int, D: int, A: int = 512
) -> SlamState:
    """A stacked SlamState for S sequences (leading axis on every leaf)."""
    one = SlamState.create(F=F, P=Pcap, O=O, K=K, D=D, A=A)
    return jax.tree.map(lambda x: jnp.broadcast_to(x, (S,) + x.shape), one)


def seq_sharding(mesh: Mesh, axis: str = "seq"):
    """NamedSharding placing the leading (sequence) axis on `axis`."""
    return NamedSharding(mesh, P(axis))


def shard_states(states: SlamState, mesh: Mesh, axis: str = "seq") -> SlamState:
    sh = seq_sharding(mesh, axis)
    return jax.tree.map(lambda x: jax.device_put(x, sh), states)


def local_row_indices(mesh: Mesh, S_global: int, axis: str = "seq") -> list[int]:
    """Global sequence rows whose 'seq' shard lives on THIS process's devices
    (sorted ascending). Single-process: all rows."""
    sh = seq_sharding(mesh, axis)
    pid = jax.process_index()
    rows: set[int] = set()
    for dev, idx in sh.devices_indices_map((S_global,)).items():
        if dev.process_index == pid:
            sl = idx[0]
            rows.update(range(sl.start or 0, sl.stop or S_global))
    return sorted(rows)


def multi_sequence_step(
    mesh: Mesh,
    *,
    cam: Camera,
    cfg: SlamConfig,
    frontend,
    axis: str = "seq",
):
    """Build the jitted S-sequence batched tracking step.

    Returns fn(states, imgs [S, N, H, W], keys [S, N], active [S, N], mask)
    -> (states, infos), with every argument and result sharded over `axis`.
    """
    step = partial(slam_step_batch, cam=cam, cfg=cfg, frontend=frontend)

    def stepped(states, imgs, keys, active, mask):
        return jax.vmap(
            lambda st, im, ke, ac: step(st, im, ke, ac, mask)
        )(states, imgs, keys, active)

    sh = seq_sharding(mesh, axis)
    spec = P(axis)
    # A single sharding/spec acts as a pytree prefix: every leaf of the
    # states / infos pytrees gets its leading axis placed on `axis`.
    local = jax.shard_map(
        stepped,
        mesh=mesh,
        in_specs=(spec, spec, spec, spec, P()),
        out_specs=(spec, spec),
        check_vma=False,
    )
    return jax.jit(
        local,
        in_shardings=(sh, sh, sh, sh, None),
        out_shardings=(sh, sh),
    )


class MultiSlam:
    """Host driver for S concurrent sequences on one mesh (deployment shape).

    Mirrors the single-sequence Slam driver (slam/pipeline.py) but steps all
    sequences in lockstep batched dispatches. Initialization runs per
    sequence on the single-chip path (it is control-flow heavy and happens
    once), then states are stacked and sharded.

    `videos` are THIS process's sequences (all sequences when single-process).
    On a multi-host mesh every process must construct MultiSlam and call
    initialize()/run_batched() in lockstep; see the module docstring.

    When the mesh has an 'lm' axis, `refine_every > 0` runs a periodic
    landmark-sharded FULL bundle adjustment over every sequence's live map
    (parallel/refine.py) — the global-optimization stage the reference's
    single-process Ceres never had (its per-commit BA freezes all previous
    keyframes, src/Slam.cpp:202-213), and the job of the mesh's 'lm' axis.
    """

    def __init__(
        self,
        cam: Camera,
        videos: list,
        mesh: Mesh,
        config: SlamConfig = SlamConfig(),
        static_mask: np.ndarray | None = None,
        seed: int = 0,
        frontend=None,
        refine_every: int = 0,
        refine_iters: int = 10,
    ):
        from ..slam.pipeline import Slam

        self.mesh = mesh
        self.cam = cam
        self.cfg = config
        self.n_proc = jax.process_count()
        S_local = len(videos)
        if self.n_proc > 1:
            # Every process MUST bring the same number of sequences: S (and
            # with it PRNG key tables and every collective shape) is derived
            # from it, so uneven counts would diverge into hangs instead of
            # an error (advisor r3).
            from jax.experimental import multihost_utils

            counts = np.asarray(
                multihost_utils.process_allgather(np.array([S_local]))
            ).ravel()
            if not np.all(counts == S_local):
                raise ValueError(
                    f"uneven per-process sequence counts {counts.tolist()} — "
                    "every process must pass the same number of videos"
                )
        self.S = S_local * self.n_proc  # global sequence count
        if self.S % mesh.shape["seq"] != 0:
            raise ValueError(
                f"{self.S} sequences not divisible by seq axis "
                f"{mesh.shape['seq']}"
            )
        self.local_rows = local_row_indices(mesh, self.S)
        if len(self.local_rows) != S_local:
            raise ValueError(
                f"this process's devices hold {len(self.local_rows)} sequence "
                f"rows of the 'seq' sharding but {S_local} videos were given"
            )
        if not np.array_equal(
            np.asarray(self.local_rows),
            np.arange(self.local_rows[0], self.local_rows[0] + S_local),
        ):
            raise ValueError(
                f"this process's sequence rows {list(self.local_rows)} are "
                "not a contiguous ascending block; the _allgather row "
                "ordering assumes process-major ascending row blocks"
            )
        # Seed per GLOBAL row so every process derives identical PRNG streams
        # and a multi-host run reproduces the single-process trajectories.
        self._slams = [
            Slam(cam, v, config, static_mask=static_mask, seed=seed + g,
                 frontend=frontend)
            for g, v in zip(self.local_rows, videos)
        ]
        self.frontend = self._slams[0].frontend
        self._key = jax.random.PRNGKey(seed ^ 0x5EED)
        self._step = multi_sequence_step(
            mesh, cam=cam, cfg=config, frontend=self.frontend
        )
        self._mask = None if static_mask is None else jnp.asarray(static_mask)
        self.states: SlamState | None = None
        # Per-sequence failure detection / recovery (parity with the
        # single-sequence driver's reinit_on_lost; Slam._check_batch).
        # Streak counters are GLOBAL (every process tracks all sequences so
        # loss decisions are made identically everywhere).
        self._lost_streak = np.zeros(self.S, np.int64)
        self.finished = np.zeros(self.S, bool)  # EOF hit during re-bootstrap
        self.segments: list = []
        self.refine_every = refine_every
        self._refine = None
        self.refine_costs: list = []
        if refine_every:
            if "lm" not in mesh.axis_names:
                raise ValueError("refine_every needs an 'lm' mesh axis")
            from .refine import make_refine_step

            # The matcher reads the cached obs_desc, which refinement leaves
            # stale only in VALUE (descriptors never change — only poses and
            # points move), so no refresh is needed.
            self._refine = make_refine_step(
                cam, mesh, max_iters=refine_iters,
            )

    # -- tiny cross-process helpers (no-ops at 1 process) --------------------
    def _allgather(self, x: np.ndarray) -> np.ndarray:
        """[S_local, ...] per-process -> [S_global, ...] on every process,
        rows ordered by global index (processes own ascending row blocks)."""
        if self.n_proc == 1:
            return np.asarray(x)
        from jax.experimental import multihost_utils

        out = np.asarray(multihost_utils.process_allgather(np.asarray(x)))
        return out.reshape((-1,) + out.shape[2:])

    def _read_rows(self, arr) -> np.ndarray:
        """Seq-sharded device array [S_global, ...] -> global np array on
        every process (addressable shards + allgather)."""
        if self.n_proc == 1:
            return np.asarray(arr)
        return self._allgather(self._local_leaf(arr))

    def _local_leaf(self, arr) -> np.ndarray:
        """[S_global, ...] seq-sharded leaf -> this process's [S_local, ...]
        rows (addressable shards only, deduped across 'lm' replication)."""
        by_start: dict[int, np.ndarray] = {}
        for s in arr.addressable_shards:
            sl = s.index[0] if s.index else slice(None)
            start = sl.start or 0
            if start not in by_start:
                by_start[start] = np.asarray(s.data)
        return np.concatenate([by_start[k] for k in sorted(by_start)], axis=0)

    def _host_local_states(self) -> SlamState:
        """Pull this process's rows of the stacked state to host numpy."""
        return jax.tree.map(self._local_leaf, self.states)

    def _put_states(self, local_states) -> SlamState:
        """Assemble the global stacked state from process-local rows."""
        sh = seq_sharding(self.mesh)
        return jax.tree.map(
            lambda x: put_sharded(np.asarray(x), sh), local_states
        )

    # -- lifecycle -----------------------------------------------------------
    def initialize(self) -> bool:
        ok = all(s.initialize() for s in self._slams)
        ok = bool(np.all(self._allgather(np.array([ok]))))
        if not ok:
            return False
        self.states = self._put_states(
            jax.tree.map(
                lambda *xs: np.stack([np.asarray(x) for x in xs]),
                *[s.state for s in self._slams],
            )
        )
        return True

    def run_batched(self, max_frames: int | None = None, batch: int = 16) -> int:
        """Step every sequence `batch` frames per dispatch until all EOF."""
        assert self.states is not None, "call initialize() first"
        S_local = len(self._slams)
        total = 0
        batches = 0
        sh = seq_sharding(self.mesh)
        # Loss detection reads the PREVIOUS batch's infos each iteration: by
        # then its scalars have finished computing (the current batch was
        # dispatched on top), so the readback never stalls the pipeline, and
        # every batch's match counts feed the streak counters (same pattern
        # as Slam.run_batched).
        pending: tuple | None = None
        while max_frames is None or total < max_frames:
            want = batch if max_frames is None else min(batch, max_frames - total)
            frames = [s._decode_batch(want) for s in self._slams]
            ns = [len(f) for f in frames]
            ns_global = self._allgather(np.asarray(ns))
            n = int(ns_global.max()) if len(ns_global) else 0
            if n == 0:
                break
            H, W = self.cam.height, self.cam.width
            imgs = np.zeros((S_local, batch, H, W), np.uint8)
            active = np.zeros((S_local, batch), bool)
            for i, fl in enumerate(frames):
                for j, f in enumerate(fl):
                    imgs[i, j] = f
                    active[i, j] = True
            # Derive the GLOBAL key table and slice this process's rows, so
            # every sequence sees the same stream regardless of process count.
            self._key, k = jax.random.split(self._key)
            keys = np.asarray(
                jax.random.split(k, self.S * batch)
            ).reshape(self.S, batch, -1)[self.local_rows]
            self.states, infos = self._step(
                self.states,
                put_sharded(imgs, sh),
                put_sharded(keys, sh),
                put_sharded(active, sh),
                self._mask,
            )
            total += n
            batches += 1
            if self.cfg.reinit_on_lost:
                if pending is not None:
                    self._check_lost(*pending)
                pending = (infos, ns_global)
            if self._refine is not None and batches % self.refine_every == 0:
                self.states, cost = self._refine(self.states)
                self.refine_costs.append(cost)
        # Drain the final pending check (its batch has finished by now) so a
        # sequence lost in the last batch still gets its segment archived.
        if pending is not None:
            self._check_lost(*pending)
        return total

    # -- failure detection / recovery ---------------------------------------
    def _check_lost(self, infos, ns_global: np.ndarray) -> None:
        """Declare a sequence lost after `lost_patience` consecutive
        low-INLIER frames (same rule as Slam._check_batch; see
        StepInfo.n_inliers for why raw match counts are not a loss signal),
        archive its finished segment, and re-bootstrap it from its current
        stream position — the other sequences keep tracking undisturbed.
        Runs the SAME decision on every process (global counts); only the
        owning process touches the lost sequence's data."""
        counts = self._read_rows(infos.n_inliers)  # [S_global, batch]
        lost: list[int] = []
        for g in range(self.S):
            if ns_global[g] == 0 or self.finished[g]:
                continue
            run = int(self._lost_streak[g])
            for c in counts[g, : ns_global[g]]:
                run = run + 1 if c < self.cfg.min_track_matches else 0
            self._lost_streak[g] = run
            if run >= self.cfg.lost_patience:
                lost.append(g)
        if not lost:
            return
        local = self._host_local_states()
        for g in lost:
            self._lost_streak[g] = 0
            if g in self.local_rows:
                local = self._reinit_sequence(g, local)
        self.states = self._put_states(local)

    def _reinit_sequence(self, g: int, local: SlamState) -> SlamState:
        """Archive global sequence g's segment and re-bootstrap it from its
        current stream position. `local` is this process's host-side rows;
        returns it with row g replaced (blank if EOF hit re-bootstrapping)."""
        i = self.local_rows.index(g)
        s = self._slams[i]
        s.state = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)[i]), local)
        self.segments.append(
            dict(
                seq=g,
                poses=s.poses(include_archived=True),
                frame_indices=s.keyframe_indices(include_archived=True),
                points=s.points(),
            )
        )
        s.reset_state()
        if not s.initialize():
            # EOF during re-bootstrap: the sequence is finished. Still write
            # the blank reset state back so later refine/accessor passes do
            # not keep operating on the archived lost map (the zero valid
            # masks make the blank row a no-op in refinement).
            self.finished[g] = True
        return self._set_row(local, i, s.state)

    @staticmethod
    def _set_row(local: SlamState, i: int, one: SlamState) -> SlamState:
        def leaf(row, x):
            row = np.array(row)  # copy
            row[i] = np.asarray(x)
            return row

        return jax.tree.map(leaf, local, one)

    def refine_map(self):
        """Run one landmark-sharded full-map BA over all sequences now."""
        assert self._refine is not None, "construct with refine_every > 0"
        self.states, cost = self._refine(self.states)
        self.refine_costs.append(cost)
        return cost

    def states_per_sequence(self) -> list[SlamState]:
        """This process's sequences' states (all of them single-process),
        in `videos` order."""
        local = self._host_local_states()
        return [
            jax.tree.map(lambda x: np.asarray(x)[i], local)
            for i in range(len(self._slams))
        ]
