"""Scrub-and-repair: turn detected damage back into healthy replicas.

:func:`repair_step` is the detect-and-repair half of
``CheckpointManager.validate(step, repair=True)`` — the anti-entropy
pass a self-healing fleet runs after faults, node replacements, or a
cold-storage scrub flags damage.  Three repair actions, in order:

1. **PFS extent rewrite** — a rank whose aggregated-file bytes fail
   their manifest CRC (bit flip, torn write, lost file) is rewritten
   *in place* from a surviving L1 or partner copy.  The columnar
   :class:`~repro_torch.core.serialize.Placement` gives the exact
   ``(file, file_offset, src_offset, size)`` extents of that rank, so
   the rewrite touches only the damaged rank's bytes — never the whole
   aggregated file.
2. **L1 / partner re-replication** — a home-node blob lost to
   ``drop_node`` (node failure + replacement) is written back from the
   PFS copy (CRC-verified on read), and, with partner replication
   configured, so is the partner replica: the replica count heals back
   to its configured level instead of staying degraded forever.
3. **Quarantine** — a rank with *no* intact copy on any level is
   irreparable; the step's manifests are flipped to
   ``status="quarantined"`` (terminal), which the restore ladder,
   ``steps()``, delta-base selection and GC all honor — a quarantined
   step can delay a restore (fall back to an older step), never corrupt
   one.  Delta descendants of a quarantined step decode through its
   bytes (``CHUNK_BASE``/``CHUNK_DELTA`` chunks), so the delta chain is
   walked and every descendant is marked suspect and quarantined with
   it.

Repairs use the same hardened I/O as the rest of the runtime: blob
reads/writes go through :class:`~repro_torch.core.storage.LocalStore` (retry
+ structured errors) and PFS reads through the executor's read plans;
the targeted extent pwrites are wrapped in the manager's
:class:`~repro_torch.core.storage.RetryPolicy`.
"""
from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.integrity import crc32
from repro_torch.core.serialize import Manifest

log = logging.getLogger("repro_torch.repair")


@dataclass
class RepairReport:
    """What one :func:`repair_step` pass did (all rank lists sorted)."""

    step: int
    pfs_repaired: List[int] = field(default_factory=list)
    l1_restored: List[int] = field(default_factory=list)
    partner_restored: List[int] = field(default_factory=list)
    unrepairable: List[int] = field(default_factory=list)
    quarantined: bool = False
    #: delta descendants of a quarantined step — marked suspect and
    #: quarantined with it (their chunks decode through its bytes)
    suspect_descendants: List[int] = field(default_factory=list)
    errors: List[str] = field(default_factory=list)

    @property
    def repaired(self) -> bool:
        return bool(self.pfs_repaired or self.l1_restored or self.partner_restored)

    def as_dict(self) -> Dict:
        return {
            "step": self.step,
            "pfs_repaired": list(self.pfs_repaired),
            "l1_restored": list(self.l1_restored),
            "partner_restored": list(self.partner_restored),
            "unrepairable": list(self.unrepairable),
            "quarantined": self.quarantined,
            "suspect_descendants": list(self.suspect_descendants),
            "errors": list(self.errors),
        }


# ---------------------------------------------------------------- manifests


def _load_any_manifest(mgr, step: int, *, pfs: bool) -> Optional[Manifest]:
    """Manifest of ``step`` in *any* status (repair must see quarantined
    and partial steps the restore-path loaders rightly reject)."""
    p = (
        mgr.pfs_dir / f"step_{step:08d}" / "manifest.json"
        if pfs
        else mgr.root / "local" / "manifests" / f"step_{step:08d}.json"
    )
    try:
        return mgr._cached_manifest(p)
    except Exception:
        return None


def _known_steps(mgr) -> List[int]:
    out = set()
    for p in (mgr.root / "local" / "manifests").glob("step_*.json"):
        try:
            out.add(int(p.stem[5:]))
        except ValueError:
            continue
    for d in mgr.pfs_dir.glob("step_*"):
        try:
            out.add(int(d.name[5:]))
        except ValueError:
            continue
    return sorted(out)


def _base_of(mgr, step: int) -> Optional[int]:
    for pfs in (False, True):
        man = _load_any_manifest(mgr, step, pfs=pfs)
        if man is not None:
            return man.base_step
    return None


def _descendants_of(mgr, step: int) -> List[int]:
    """Steps whose delta chain passes through ``step`` (transitively)."""
    out = []
    for s in _known_steps(mgr):
        if s == step:
            continue
        cur, seen = s, set()
        while cur is not None and cur not in seen:
            seen.add(cur)
            cur = _base_of(mgr, cur)
            if cur == step:
                out.append(s)
                break
    return out


def _ancestor_quarantined(mgr, step: int) -> Optional[int]:
    """Nearest quarantined ancestor on the delta chain, if any."""
    cur, seen = _base_of(mgr, step), set()
    while cur is not None and cur not in seen:
        seen.add(cur)
        for pfs in (True, False):
            man = _load_any_manifest(mgr, cur, pfs=pfs)
            if man is not None and man.status == "quarantined":
                return cur
        cur = _base_of(mgr, cur)
    return None


def quarantine_step(mgr, step: int) -> None:
    """Flip every manifest of ``step`` to the terminal ``quarantined``
    state (idempotent; manifests that don't exist are not created,
    except the PFS one is only rewritten where a PFS dir already is)."""
    man = _load_any_manifest(mgr, step, pfs=True)
    if man is not None and man.status != "quarantined":
        man.status = "quarantined"
        mgr._write_manifest_pfs(man)
    man = _load_any_manifest(mgr, step, pfs=False)
    if man is not None and man.status != "quarantined":
        man.status = "quarantined"
        mgr._write_manifest_local(man)
    # Never let a future delta chain onto a quarantined anchor: the
    # in-memory twin may still be intact, but deltas encoded against it
    # become undecodable the moment this process exits.
    with mgr._lock:
        if mgr._last_full is not None and mgr._last_full.step == step:
            mgr._last_full = None
            mgr._saves_since_full = 0
        if mgr._l0 is not None and mgr._l0.step == step:
            mgr._l0 = None


# ------------------------------------------------------------------ sources


def _read_l1(mgr, man: Manifest, step: int, rank: int, *, partner: bool):
    """CRC-verified L1/partner blob of ``rank``, or None."""
    ppn = max(1, man.procs_per_node)
    n_nodes = max(1, man.world_size // ppn)
    node = rank // ppn
    if partner:
        node = (node + 1) % n_nodes
    try:
        blob = mgr.local.read_blob(node, step, rank, partner=partner)
    except OSError:
        return None
    if crc32(blob) != man.ranks[rank].crc:
        return None
    return blob


def _read_pfs(mgr, man: Manifest, step: int, rank: int, layout):
    """CRC-verified PFS blob of ``rank``, or None."""
    try:
        blob = mgr.executor.read_rank_blob(man, step, rank, layout)
    except Exception:
        return None
    if crc32(blob) != man.ranks[rank].crc:
        return None
    return blob


def _rewrite_pfs_extents(mgr, man: Manifest, step: int, ranks: Dict[int, bytes]) -> None:
    """pwrite the given ranks' blobs back into the aggregated files at
    exactly the byte ranges the columnar placement assigns them."""
    pl = man.placement
    sdir = mgr.executor.step_dir(step)
    sdir.mkdir(parents=True, exist_ok=True)
    fds: Dict[int, int] = {}
    try:
        for rank, blob in ranks.items():
            mv = memoryview(blob)
            for i in np.flatnonzero(pl.rank == rank).tolist():
                fid = int(pl.file_id[i])
                fd = fds.get(fid)
                if fd is None:
                    fname = pl.file_names[fid]
                    fd = os.open(str(sdir / fname), os.O_CREAT | os.O_WRONLY, 0o644)
                    planned = man.files.get(fname)
                    if planned is not None:
                        # re-establish the planned size (no-op when the
                        # file survived; re-extends a lost/truncated one)
                        os.ftruncate(fd, int(planned))
                    fds[fid] = fd
                foff = int(pl.file_offset[i])
                soff = int(pl.src_offset[i])
                sz = int(pl.size[i])

                def _pwrite(fd=fd, mv=mv, soff=soff, sz=sz, foff=foff):
                    os.pwrite(fd, mv[soff : soff + sz], foff)

                if mgr.retry is not None:
                    mgr.retry.run(_pwrite)
                else:
                    _pwrite()
        for fd in fds.values():
            os.fsync(fd)
    finally:
        for fd in fds.values():
            try:
                os.close(fd)
            except OSError:
                pass


# ------------------------------------------------------------------- repair


def repair_step(mgr, step: int, *, scrub: Optional[Dict] = None) -> RepairReport:
    """Detect-and-repair one step across the multi-level ladder.

    ``mgr`` is the :class:`~repro_torch.core.engine.CheckpointManager`;
    ``scrub`` may carry a just-computed ``validate()`` report to skip
    re-probing levels it already CRC-checked.  Returns a
    :class:`RepairReport`; irreparable damage quarantines the step (and
    its delta descendants) rather than ever leaving wrong bytes
    restorable.
    """
    rep = RepairReport(step=step)
    man_pfs = _load_any_manifest(mgr, step, pfs=True)
    man_local = _load_any_manifest(mgr, step, pfs=False)
    man = man_pfs if man_pfs is not None else man_local
    if man is None:
        rep.errors.append(f"step {step}: no manifest on any level")
        return rep
    if (man_pfs is not None and man_pfs.status == "quarantined") or (
        man_local is not None and man_local.status == "quarantined"
    ):
        quarantine_step(mgr, step)  # idempotent: align both manifests
        rep.quarantined = True
        return rep
    anc = _ancestor_quarantined(mgr, step)
    if anc is not None:
        # a damaged CHUNK_BASE ancestor poisons every descendant: this
        # step's delta chunks decode through bytes that no longer exist
        rep.errors.append(f"delta ancestor step {anc} is quarantined")
        rep.quarantined = True
        quarantine_step(mgr, step)
        log.warning("step %d quarantined: ancestor %d is quarantined", step, anc)
        return rep

    # the PFS level is a trusted source/repair target only once its
    # flush completed — partial flushes belong to resume_flushes()
    pfs_trusted = man_pfs is not None and man_pfs.status == "flush_done"
    ppn = max(1, man.procs_per_node)
    n_nodes = max(1, man.world_size // ppn)
    replicate = bool(getattr(mgr.cfg, "partner_replication", False)) and n_nodes > 1
    scrub = scrub or {}
    layout = None
    if pfs_trusted:
        try:
            layout = man_pfs.file_layout()
        except Exception:
            layout = None

    # ---- per-rank source census (lazy blob reads, scrub-informed) ----
    l1_blob: Dict[int, bytes] = {}
    partner_blob: Dict[int, bytes] = {}
    pfs_bad: List[int] = []
    for r in range(man.world_size):
        if pfs_trusted:
            ok = scrub.get("pfs", {}).get(r)
            if ok is None:
                ok = _read_pfs(mgr, man_pfs, step, r, layout) is not None
            if not ok:
                pfs_bad.append(r)

    # ---- 1. PFS extent rewrite from surviving L1/partner copies ----
    if pfs_trusted and pfs_bad:
        fixes: Dict[int, bytes] = {}
        for r in pfs_bad:
            blob = _read_l1(mgr, man, step, r, partner=False)
            if blob is not None:
                l1_blob[r] = blob
            elif replicate:
                blob = _read_l1(mgr, man, step, r, partner=True)
                if blob is not None:
                    partner_blob[r] = blob
            if blob is not None:
                fixes[r] = blob
        if fixes:
            try:
                _rewrite_pfs_extents(mgr, man_pfs, step, fixes)
                for r in sorted(fixes):
                    # trust only a verified rewrite
                    if _read_pfs(mgr, man_pfs, step, r, layout) is not None:
                        rep.pfs_repaired.append(r)
                    else:
                        rep.errors.append(
                            f"rank {r}: PFS rewrite did not verify"
                        )
            except Exception as e:
                rep.errors.append(f"PFS extent rewrite failed: {e!r}")

    # ---- 2. anti-entropy: re-replicate L1 / partner from the PFS ----
    still_bad_pfs = set(pfs_bad) - set(rep.pfs_repaired)
    if man_local is not None:
        for r in range(man.world_size):
            need_home = _read_l1(mgr, man, step, r, partner=False) is None
            need_partner = (
                replicate
                and _read_l1(mgr, man, step, r, partner=True) is None
            )
            if not (need_home or need_partner):
                continue
            blob = l1_blob.get(r)
            if blob is None:
                blob = partner_blob.get(r)
            if blob is None and not need_home:
                # surviving home copy heals a lost/corrupt partner
                blob = _read_l1(mgr, man, step, r, partner=False)
            if blob is None and replicate and not need_partner:
                # surviving partner copy heals a lost/corrupt home
                blob = _read_l1(mgr, man, step, r, partner=True)
            if blob is None and pfs_trusted and r not in still_bad_pfs:
                blob = _read_pfs(mgr, man_pfs, step, r, layout)
            if blob is None:
                continue  # rank-level verdict handled below
            node = r // ppn
            try:
                if need_home:
                    mgr.local.write_blob(node, step, r, blob)
                    rep.l1_restored.append(r)
                if need_partner:
                    mgr.local.write_blob(
                        (node + 1) % n_nodes, step, r, blob, partner=True
                    )
                    rep.partner_restored.append(r)
            except OSError as e:
                rep.errors.append(f"rank {r}: re-replication failed: {e!r}")

    # ---- 3. quarantine: any rank with no intact copy anywhere ----
    for r in range(man.world_size):
        pfs_ok = pfs_trusted and r not in still_bad_pfs
        l1_ok = _read_l1(mgr, man, step, r, partner=False) is not None
        p_ok = replicate and _read_l1(mgr, man, step, r, partner=True) is not None
        if not (pfs_ok or l1_ok or p_ok):
            rep.unrepairable.append(r)
    if rep.unrepairable:
        rep.quarantined = True
        quarantine_step(mgr, step)
        rep.suspect_descendants = _descendants_of(mgr, step)
        for d in rep.suspect_descendants:
            quarantine_step(mgr, d)
        log.warning(
            "step %d quarantined (ranks %s irreparable); "
            "descendants quarantined: %s",
            step, rep.unrepairable[:8], rep.suspect_descendants,
        )
    elif rep.repaired:
        log.info(
            "step %d repaired: pfs=%s l1=%s partner=%s",
            step, rep.pfs_repaired, rep.l1_restored, rep.partner_restored,
        )
    return rep
