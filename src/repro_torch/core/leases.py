"""Lease-based cache tier: commit-time push invalidation and
bounded-staleness reads (ROADMAP item 3; Cloudburst arXiv 2001.04592,
λFS arXiv 2306.11877).

The client LRU in ``core/client.py`` is per-container and only as fresh
as its last ``begin`` snapshot: every read-mostly invocation still pays
a begin round trip to stay current. This module adds the tier that lets
readers scale off the commit path entirely:

  * **Read leases.** A client registers interest in the files it reads
    (``T_LEASE``); the server keeps a per-file holder table
    (``LeaseTable``) with a TTL. Leases are *interest registrations*,
    not locks — they gate nothing and conflict with nothing.
  * **Commit-time push.** A committing writer revokes holders over the
    already-open multiplexed connection via server-initiated frames
    (request id 0): ``T_INVALIDATE`` ends the holders' cache view;
    ``T_PUSH_VERSION`` additionally carries the committed blocks so the
    holder's LRU is warm before its next snapshot.
  * **Bounded-staleness views.** ``LocalServer.begin(read_only=True,
    max_staleness_s=B)`` may reuse the LAST real begin's read timestamp
    with ZERO server round trips while ``monotonic() - view_start <=
    B`` and no revoke arrived. All functions sharing one ``LocalServer``
    (one warm container / ``FunctionRuntime``) share the view and its
    name/meta caches.

**Why this is safe.** A snapshot at a fixed past timestamp is immutable
history: a view-served read-only transaction is *exactly* the snapshot
transaction a real begin at that timestamp would have produced, so it
is serializable no matter what was lost — a dead connection, a dropped
push, a server restart, a mid-rebalance ``StaleShardMap``. The
staleness *bound* is enforced purely by the local monotonic clock
(anchored BEFORE the real begin RPC was sent, so network time counts
against the bound, never for it). Leases and pushes only improve
freshness within the bound; commit validation remains the sole source
of truth for writers. The failure matrix lives in docs/caching.md.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from repro_torch.core import obs, wire

MODE_INV = "inv"    # revoke-only: holders drop their view
MODE_PUSH = "push"  # revoke + ship the committed blocks

DEFAULT_TTL_S = 30.0

# --------------------------------------------------------------------------- #
# metrics, pre-bound at import time (see core/obs.py)
# --------------------------------------------------------------------------- #
_GRANTS = obs.REGISTRY.counter(
    "faasfs_lease_grants_total", help="read leases granted",
).labels()
_RELEASES = obs.REGISTRY.counter(
    "faasfs_lease_releases_total", help="read leases released early",
).labels()
_EXPIRIES = obs.REGISTRY.counter(
    "faasfs_lease_expiries_total", help="read leases expired (TTL)",
).labels()
_REVOKES = obs.REGISTRY.counter(
    "faasfs_lease_revokes_total", labels=("mode",),
    help="commit-time revocations delivered to this holder",
)
_REVOKES_INV = _REVOKES.labels(MODE_INV)
_REVOKES_PUSH = _REVOKES.labels(MODE_PUSH)
_TIER_HITS = obs.REGISTRY.counter(
    "faasfs_lease_cache_hits_total", labels=("tier",),
    help="lease-tier cache hits by tier",
)
_TIER_MISSES = obs.REGISTRY.counter(
    "faasfs_lease_cache_misses_total", labels=("tier",),
    help="lease-tier cache misses by tier",
)
_HIT_VIEW, _MISS_VIEW = _TIER_HITS.labels("view"), _TIER_MISSES.labels("view")
_HIT_NAME, _MISS_NAME = _TIER_HITS.labels("name"), _TIER_MISSES.labels("name")
_HIT_META, _MISS_META = _TIER_HITS.labels("meta"), _TIER_MISSES.labels("meta")
_PUSH_US = obs.REGISTRY.histogram(
    "faasfs_lease_push_us", buckets=obs.PUSH_BUCKETS_US, unit="us",
    help="commit-apply to holder-notified push-invalidation latency",
).labels()
_PUSH_ERRORS = obs.REGISTRY.counter(
    "faasfs_lease_push_errors_total",
    help="push-frame generation failures (commit already acked)",
).labels()
_PUSH_FANOUT = obs.REGISTRY.counter(
    "faasfs_lease_push_fanout_total", labels=("type",),
    help="per-holder frames queued at commit time (fan-out cost), by type",
)
_FANOUT_INV = _PUSH_FANOUT.labels("invalidate")
_FANOUT_PUSH = _PUSH_FANOUT.labels("push_version")


# --------------------------------------------------------------------------- #
# touched-set extraction (what a commit means to lease holders)
# --------------------------------------------------------------------------- #
def touched_payload(payload) -> Tuple[Set[int], List[str]]:
    """(file ids, names) a ``TxnPayload``'s effects touch: block writes,
    meta updates (incl. tombstones and dir-generation bumps), and name
    (re)bindings — the fid a name now points at counts as touched."""
    fids = {w.key[0] for w in payload.writes}
    fids.update(payload.meta_updates)
    fids.update(f for f in payload.name_updates.values() if f is not None)
    return fids, list(payload.name_updates)


def touched_obj(obj: Dict[str, Any]) -> Tuple[Set[int], List[str], List[Tuple]]:
    """Same, from the raw wire commit object (server side, pre-decode);
    additionally returns the write block keys for push-mode bodies."""
    write_keys = [tuple(k) for k, _ in obj.get("w", ())]
    fids = {k[0] for k in write_keys}
    fids.update(obj.get("mu") or ())
    nu = obj.get("nu") or {}
    fids.update(f for f in nu.values() if f is not None)
    return fids, list(nu), write_keys


# --------------------------------------------------------------------------- #
# server side: the lease table
# --------------------------------------------------------------------------- #
class LeaseTable:
    """Per-file holder registrations with a TTL.

    Holders are opaque (the server uses its ``_Conn`` objects). The
    table is queried from worker threads (commit push generation) and
    the event loop (grant/release/conn close), so it carries its own
    mutex. Expired leases are pruned lazily — on the grant and lookup
    paths — and counted; additionally, every lease operation runs a
    TTL-gated sweep of the WHOLE table, so leases on fids never touched
    again (a long-lived holder over many distinct files, or a
    misbehaving client looping T_LEASE over fresh ids) are reclaimed
    within one TTL of any lease traffic rather than held until the
    connection closes."""

    def __init__(self, ttl_s: float = DEFAULT_TTL_S):
        self.ttl_s = float(ttl_s)
        self._mu = threading.Lock()
        self._held: Dict[Any, Dict[int, float]] = {}   # holder -> fid -> dl
        self._modes: Dict[Any, str] = {}
        self._by_fid: Dict[int, Set[Any]] = {}
        self._next_sweep = 0.0
        self.grants = 0
        self.releases = 0
        self.expiries = 0

    def _maybe_sweep_locked(self, now: float) -> None:
        if now < self._next_sweep:
            return
        self._next_sweep = now + self.ttl_s
        expired = 0
        for holder in list(self._held):
            held = self._held[holder]
            for fid in [f for f, dl in held.items() if dl < now]:
                del held[fid]
                self._discard_locked(fid, holder)
                expired += 1
            if not held:
                self._forget_locked(holder)
        if expired:
            self.expiries += expired
            _EXPIRIES.inc(expired)

    def grant(self, holder: Any, fids, mode: str = MODE_INV,
              now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        deadline = now + self.ttl_s
        granted: List[int] = []
        with self._mu:
            self._maybe_sweep_locked(now)
            held = self._held.setdefault(holder, {})
            self._modes[holder] = (
                MODE_PUSH if mode == MODE_PUSH else MODE_INV
            )
            for fid in fids:
                held[int(fid)] = deadline
                self._by_fid.setdefault(int(fid), set()).add(holder)
                granted.append(int(fid))
            self.grants += len(granted)
        _GRANTS.inc(len(granted))
        return granted

    def release(self, holder: Any, fids) -> int:
        n = 0
        with self._mu:
            held = self._held.get(holder)
            if held:
                for fid in fids:
                    if held.pop(int(fid), None) is not None:
                        n += 1
                        self._discard_locked(int(fid), holder)
                if not held:
                    self._forget_locked(holder)
            self.releases += n
        _RELEASES.inc(n)
        return n

    def drop_holder(self, holder: Any) -> int:
        """Connection death: leases die with the connection."""
        with self._mu:
            held = self._held.pop(holder, None)
            self._modes.pop(holder, None)
            if not held:
                return 0
            for fid in held:
                self._discard_locked(fid, holder)
            return len(held)

    def _discard_locked(self, fid: int, holder: Any) -> None:
        hs = self._by_fid.get(fid)
        if hs is not None:
            hs.discard(holder)
            if not hs:
                del self._by_fid[fid]

    def _forget_locked(self, holder: Any) -> None:
        self._held.pop(holder, None)
        self._modes.pop(holder, None)

    def holders_for(
        self, fids, now: Optional[float] = None
    ) -> Dict[Any, Tuple[str, List[int]]]:
        """Live holders with a lease on any of ``fids``:
        ``{holder: (mode, [touched fids it holds])}``. Expired entries
        encountered on the way are pruned and counted."""
        now = time.monotonic() if now is None else now
        out: Dict[Any, Tuple[str, List[int]]] = {}
        expired = 0
        with self._mu:
            self._maybe_sweep_locked(now)
            for fid in fids:
                fid = int(fid)
                for holder in list(self._by_fid.get(fid, ())):
                    held = self._held.get(holder)
                    deadline = held.get(fid) if held else None
                    if deadline is None or deadline < now:
                        if held is not None and held.pop(fid, None) is not None:
                            expired += 1
                            self.expiries += 1
                            if not held:
                                self._forget_locked(holder)
                        self._discard_locked(fid, holder)
                        continue
                    out.setdefault(
                        holder, (self._modes.get(holder, MODE_INV), [])
                    )[1].append(fid)
        if expired:
            _EXPIRIES.inc(expired)
        return out

    def holder_count(self, now: Optional[float] = None) -> int:
        """Holders with at least one LIVE (unexpired) lease."""
        now = time.monotonic() if now is None else now
        with self._mu:
            return sum(
                1 for held in self._held.values()
                if any(dl >= now for dl in held.values())
            )

    def lease_count(self, now: Optional[float] = None) -> int:
        """Live (unexpired) leases across all holders."""
        now = time.monotonic() if now is None else now
        with self._mu:
            return sum(
                sum(1 for dl in held.values() if dl >= now)
                for held in self._held.values()
            )


# --------------------------------------------------------------------------- #
# in-process delivery: the broker (mono / in-proc sharded backends)
# --------------------------------------------------------------------------- #
class LeaseBroker:
    """Commit-effects fan-out for backends living in the SAME process as
    their clients — the in-proc twin of the server's push frames. The
    backend's ``on_commit_effects(ts, payload)`` hook (fired after the
    commit reply, outside commit locks) publishes to every subscribed
    tier."""

    def __init__(self):
        self._mu = threading.Lock()
        self._subs: List[Callable] = []

    def subscribe(self, cb: Callable) -> None:
        with self._mu:
            if cb not in self._subs:
                self._subs.append(cb)

    def unsubscribe(self, cb: Callable) -> None:
        with self._mu:
            if cb in self._subs:
                self._subs.remove(cb)

    def on_commit(self, ts, payload) -> None:
        fids, names = touched_payload(payload)
        if not fids and not names:
            return
        us = obs.now_us()
        with self._mu:
            subs = list(self._subs)
        for cb in subs:
            try:
                cb(ts, fids, names, us)
            except Exception:
                _PUSH_ERRORS.inc()


def broker_for(backend) -> LeaseBroker:
    """The (singleton) broker of an in-proc backend; created on first
    use and wired into the backend's ``on_commit_effects`` hook."""
    br = getattr(backend, "_lease_broker", None)
    if br is None:
        br = LeaseBroker()
        backend._lease_broker = br
        backend.on_commit_effects = br.on_commit
    return br


# --------------------------------------------------------------------------- #
# client side: the tier
# --------------------------------------------------------------------------- #
class LeaseTier:
    """Per-``LocalServer`` lease state: the bounded-staleness view, the
    view-scoped name/meta caches shared by every function in the warm
    container, and the lease-acquisition bookkeeping.

    Thread-safety: pushes arrive on the transport reader thread (or, in
    proc, on a committer's thread) while invocations run elsewhere —
    all mutable state sits behind ``_mu``.

    The view handshake closes the push/begin race: ``begin_token()``
    snapshots (monotonic clock, revocation sequence) BEFORE the real
    begin RPC; ``on_real_begin`` opens the view only if no revocation
    arrived in between, because a racing push may concern a commit
    newer than the begin's read timestamp."""

    def __init__(self, local, max_staleness_s: Optional[float] = 1.0,
                 mode: str = MODE_INV, lease_ttl_s: float = DEFAULT_TTL_S):
        self.local = local
        self.max_staleness_s = max_staleness_s
        self.mode = MODE_PUSH if mode == MODE_PUSH else MODE_INV
        self._mu = threading.Lock()
        self._view_ts: Any = None
        self._view_start = 0.0
        self._view_ok = False
        self._inv_seq = 0           # bumped by every revocation
        self._names: Dict[str, Tuple[Any, Optional[int]]] = {}
        self._metas: Dict[int, Tuple[Any, Any]] = {}
        self._deadlines: Dict[int, float] = {}
        self._ttl = float(lease_ttl_s)
        self._rb = None             # RemoteBackend carrying wire leases
        self._broker: Optional[LeaseBroker] = None
        self._transport_gen = (0, 0)  # (reconnects, disconnects) last seen
        # plain counters (metrics twin them in the registry)
        self.view_hits = 0
        self.view_misses = 0
        self.revokes = 0

    # -- transport attachment ------------------------------------------- #
    def bind_remote(self, rb) -> None:
        self._rb = rb
        self._transport_gen = (rb.reconnects, rb.disconnects)
        rb.set_push_handler(self._on_push)

    def bind_broker(self, broker: LeaseBroker) -> None:
        self._broker = broker
        broker.subscribe(self._on_broker_commit)

    def close(self) -> None:
        if self._rb is not None:
            self._rb.set_push_handler(None)
        if self._broker is not None:
            self._broker.unsubscribe(self._on_broker_commit)

    # -- view lifecycle (LocalServer.begin drives these) ---------------- #
    def _check_transport(self) -> None:
        rb = self._rb
        if rb is None:
            return
        gen = (rb.reconnects, rb.disconnects)
        if gen != self._transport_gen:
            # the connection died (disconnects moves the moment the mux
            # reader hits EOF — before any redial): server-side leases
            # died with it, and pushes in flight were lost — clear
            # everything and force a real begin (a restart also bumped
            # the epoch; the next T_LEASE re-registers against the new
            # incarnation)
            with self._mu:
                self._transport_gen = gen
                self._deadlines.clear()
                self._view_ok = False

    def invalidate_view(self) -> None:
        """Close the current view and force the next begin to be real.
        Used when a view-served read hits truncated history — e.g.
        ``SnapshotTooOld`` after a slot migration GC'd versions older
        than the migration cut: the view is unservable, not wrong."""
        with self._mu:
            self._inv_seq += 1
            self._view_ok = False

    def begin_token(self) -> Tuple[float, int]:
        """Staleness anchor + revocation fence, captured BEFORE the real
        begin RPC leaves the client."""
        self._check_transport()
        with self._mu:
            return (time.monotonic(), self._inv_seq)

    def on_real_begin(self, read_ts, token: Tuple[float, int]) -> None:
        t0, seq = token
        rb = self._rb
        with self._mu:
            if rb is not None:
                gen = (rb.reconnects, rb.disconnects)
                if gen != self._transport_gen:
                    # the begin RPC itself redialed: the snapshot in hand
                    # came from (or is at least as fresh as) the new
                    # connection, so the view is fine — but every lease
                    # belonged to the dead connection and must be
                    # re-acquired before pushes flow again
                    self._transport_gen = gen
                    self._deadlines.clear()
            self._view_ts = read_ts
            self._view_start = t0
            # conservative: a push that raced the begin reply may concern
            # a commit NEWER than read_ts — leave the view closed and let
            # the next begin re-open it
            self._view_ok = seq == self._inv_seq
            self._names.clear()
            self._metas.clear()

    def try_view(self, max_staleness_s: Optional[float] = None):
        """The current view's read timestamp, iff it is open and within
        the staleness bound — else None (caller does a real begin)."""
        bound = (
            self.max_staleness_s if max_staleness_s is None
            else max_staleness_s
        )
        if bound is None or bound <= 0:
            return None
        self._check_transport()
        now = time.monotonic()
        with self._mu:
            ok = (
                self._view_ok
                and self._view_ts is not None
                and now - self._view_start <= bound
            )
            ts = self._view_ts if ok else None
        if ts is None:
            self.view_misses += 1
            _MISS_VIEW.inc()
        else:
            self.view_hits += 1
            _HIT_VIEW.inc()
        return ts

    # -- view-scoped name/meta caches ----------------------------------- #
    def name_get(self, path: str, at_ts):
        if at_ts is None:
            return None
        with self._mu:
            if at_ts != self._view_ts:
                return None
            ent = self._names.get(path)
        (_HIT_NAME if ent is not None else _MISS_NAME).inc()
        return ent

    def name_put(self, path: str, at_ts, ver, fid) -> None:
        if at_ts is None:
            return
        with self._mu:
            if at_ts == self._view_ts:
                self._names[path] = (ver, fid)

    def meta_get(self, fid: int, at_ts):
        if at_ts is None:
            return None
        with self._mu:
            if at_ts != self._view_ts:
                return None
            ent = self._metas.get(fid)
        (_HIT_META if ent is not None else _MISS_META).inc()
        return ent

    def meta_put(self, fid: int, at_ts, ver, meta) -> None:
        if at_ts is None:
            return
        with self._mu:
            if at_ts == self._view_ts:
                self._metas[fid] = (ver, meta)

    # -- lease acquisition ---------------------------------------------- #
    def note_access(self, fids) -> None:
        """Called when a transaction touches files by id (server-fetch
        paths only — view-served reads must stay RPC-free). Acquires or
        renews leases, fire-and-forget: the grant reply lands via the
        frame decoder, and a lost request merely costs freshness."""
        now = time.monotonic()
        want: List[int] = []
        with self._mu:
            for fid in fids:
                deadline = self._deadlines.get(fid)
                if deadline is None or deadline - now < self._ttl / 2:
                    want.append(fid)
        if not want:
            return
        rb = self._rb
        if rb is not None:
            try:
                rb.submit_frame(
                    wire.T_LEASE, {"f": want, "m": self.mode},
                    decode=self._on_grant,
                )
                rb._flush_sends()
            except Exception:
                pass  # lease acquisition is never load-bearing
        else:
            # in-proc: a lease is just broker-subscribed interest
            deadline = now + self._ttl
            with self._mu:
                for fid in want:
                    self._deadlines[fid] = deadline
            _GRANTS.inc(len(want))

    def _on_grant(self, reply: Dict[str, Any]) -> Dict[str, Any]:
        # runs as the T_LEASE frame decoder on the transport reader
        ttl = float(reply.get("ttl") or self._ttl)
        deadline = time.monotonic() + ttl
        with self._mu:
            self._ttl = ttl
            for fid in reply.get("g", ()):
                self._deadlines[fid] = deadline
        return reply

    def release_all(self) -> None:
        """Drop every lease early (T_LEASE_RELEASE); used by tests and
        graceful container teardown."""
        with self._mu:
            fids, self._deadlines = list(self._deadlines), {}
        rb = self._rb
        if fids and rb is not None:
            try:
                rb.submit_frame(wire.T_LEASE_RELEASE, {"f": fids})
                rb._flush_sends()
            except Exception:
                pass

    # -- revocation delivery -------------------------------------------- #
    def _on_push(self, msg_type: int, obj: Any) -> None:
        # RemoteBackend push handler (reader thread — must not block)
        if msg_type == wire.T_PUSH_VERSION:
            blocks = obj.get("b") or {}
            if blocks:
                self._warm(blocks)
            self._revoked(obj, push=True)
        elif msg_type == wire.T_INVALIDATE:
            self._revoked(obj, push=False)
        # unknown push types: ignore (forward compatibility)

    def _warm(self, blocks: Dict[Any, Any]) -> None:
        """Warm the shared LRU with pushed block contents — only where
        provably sound. The server drains commit completions before push
        jobs, so a push queued at commit time T can arrive AFTER a begin
        reply whose read_ts >= T: blindly storing it would overwrite a
        newer entry (or plant a stale one for a key the begin diff never
        covered, because it was absent from cached_keys), and a later
        view-served snapshot read would pass snapshot_cache_ok and
        return pre-snapshot data. Three guards, all under the cache
        lock:

          * a begin in flight (cached_keys snapshot taken, reply not yet
            applied) suspends warming entirely — a block stored now is
            invisible to that begin's diff;
          * an existing entry is only overwritten by a strictly newer
            version (the begin diff covers cached keys, so the entry is
            already the freshest covered version);
          * an absent key is only planted when the pushed version is
            NEWER than last_sync_ts (snapshot_cache_ok then keeps it
            inert until a real begin syncs past it — and that begin's
            diff covers the now-cached key).

        Skipping is always safe: pushes are freshness, the revocation
        itself ends the view either way."""
        local = self.local
        be = local.backend
        with local._lock:
            if getattr(local, "_begins_inflight", 0):
                return
            last_sync = local.last_sync_ts
            for k, vd in blocks.items():
                key = tuple(k)
                ver = vd[0]
                ent = local.cache.get(key)
                if ent is not None:
                    if not (ent.version < ver):
                        continue
                elif be.snapshot_cache_ok(key, ver, last_sync, last_sync):
                    # covered by the sync point: a version newer than
                    # this push may already be what "latest <= last_sync"
                    # means for this key
                    continue
                local._put(key, ver, vd[1])

    def _on_broker_commit(self, ts, fids: Set[int], names, us) -> None:
        with self._mu:
            interested = bool(self._deadlines.keys() & fids)
        if not interested:
            return
        self._revoked({"us": us}, push=False)

    def on_local_commit(self, payload) -> None:
        """A commit issued through this tier's OWN LocalServer: the open
        view predates it by construction, so end it synchronously — the
        warm container always reads its own writes, without waiting for
        the push to loop back through the server."""
        if payload is None or not payload.has_effects():
            return
        with self._mu:
            self._inv_seq += 1
            self._view_ok = False

    def _revoked(self, obj: Dict[str, Any], push: bool) -> None:
        us = obj.get("us")
        if us is not None:
            delta = obs.now_us() - us
            if delta >= 0:
                _PUSH_US.observe(delta)
        (_REVOKES_PUSH if push else _REVOKES_INV).inc()
        with self._mu:
            self.revokes += 1
            self._inv_seq += 1
            self._view_ok = False
            # leases persist across revocations (they are standing
            # interest registrations, renewed by TTL) — only the view
            # and its caches stop extending; entries already tagged to
            # view_ts stay correct for reads AT view_ts (immutable
            # history), so the caches are cleared on the next real
            # begin, not here

    def stats(self) -> Dict[str, int]:
        with self._mu:
            return {
                "view_hits": self.view_hits,
                "view_misses": self.view_misses,
                "revokes": self.revokes,
                "leases": len(self._deadlines),
                "names": len(self._names),
                "metas": len(self._metas),
            }


# --------------------------------------------------------------------------- #
# attachment: pick the coherence channel for whatever backend is in use
# --------------------------------------------------------------------------- #
def attach_lease_tier(
    local,
    max_staleness_s: Optional[float] = 1.0,
    mode: str = MODE_INV,
    lease_ttl_s: float = DEFAULT_TTL_S,
) -> LeaseTier:
    """Attach (or return the existing) lease tier of a ``LocalServer``.

    Dispatches on the backend kind: a ``RemoteBackend`` gets wire leases
    + push frames; a cluster client leases via its coordinator
    connection (commits serialize there, so its pushes cover every
    shard); in-proc backends subscribe to the commit-effects broker; a
    ``LatencyInjector`` (or any wrapper exposing ``.inner``) is
    unwrapped first. A backend with no coherence channel still gets
    working views — the staleness bound alone governs them."""
    existing = getattr(local, "lease_tier", None)
    if existing is not None:
        return existing
    tier = LeaseTier(local, max_staleness_s, mode, lease_ttl_s)
    be = local.backend
    hops = 0
    while hasattr(be, "inner") and hops < 8:
        be = be.inner
        hops += 1
    from repro_torch.core.remote import RemoteBackend  # lazy: import cycles

    coord = getattr(be, "coord", None)
    if isinstance(be, RemoteBackend):
        tier.bind_remote(be)
    elif isinstance(coord, RemoteBackend):
        tier.bind_remote(coord)
    elif hasattr(be, "on_commit_effects"):
        tier.bind_broker(broker_for(be))
    local.lease_tier = tier
    return tier
