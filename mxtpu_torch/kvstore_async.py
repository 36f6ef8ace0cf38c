"""The serving wire of the PyTorch port: the transport half of
``mxtpu/kvstore_async.py``, byte for byte, so either package's client
talks to the other package's server.

* **Frames.** Pickle protocol 5 with out-of-band buffers: ``<Q`` body
  length, the pickle body, ``<I`` buffer count, a ``<Q`` length a buffer,
  then the raw buffers back to back, the whole frame in one
  scatter-gather ``sendmsg`` (:func:`_send_frame`); the receiver reads
  every buffer into one blob and rebuilds the arrays from slices of it
  (:func:`_recv_frame`). A frame is ``(cid, msg)`` or ``(cid, msg,
  trace_ctx)`` from a client and ``(cid, reply)`` or, for a streamed
  partial, ``(cid, reply, "+")`` from a server. What crosses is builtins
  and numpy arrays only.
* **Auth.** With ``MXTPU_PS_TOKEN`` set the client sends a fixed-length
  raw preamble (``MXA1`` + sha256 of the token) before its first frame,
  and the server compares it before it unpickles anything
  (:func:`_auth_blob`).
* **Channels.** :class:`_ServerConn` is one client's view of one server:
  pipelined :class:`_Channel` sockets (``MXTPU_PS_CONNS``, each with a
  ``MXTPU_PS_WINDOW``-deep window of requests in flight, paired back by
  correlation id), retries with bounded exponential backoff and
  deterministic jitter (``MXTPU_PS_RETRIES``, ``MXTPU_PS_BACKOFF``,
  ``MXTPU_PS_BACKOFF_MAX``, ``MXTPU_PS_RECONNECT``), health bookkeeping
  (``MXTPU_PS_DEAD_AFTER``), and streamed replies (:meth:`_ServerConn.
  stream`). Any failure kills the whole channel: every request in
  flight fails with ConnectionError and the layer above replays.
* **The same-process shortcut.** A server that lives in this process
  registers in ``_LOCAL_SERVERS``; a client of it skips socket and
  pickle and dispatches directly, under the same fault points
  (``MXTPU_PS_LOCAL=0`` forces the wire).
* **Faults.** ``worker.send`` / ``worker.recv`` fire on the client side
  of every request, ``server.recv`` / ``server.send`` on the server's
  (:mod:`mxtpu_torch.fault`).

``mxtpu``'s parameter server, its dist_async store, replication and
elasticity wait for the port of the distributed kvstore, which extends
this module.
"""
from __future__ import annotations

import itertools
import os
import pickle
import socket
import socketserver
import struct
import sys
import threading
import time
import zlib

from . import fault as _fault
from . import obs as _obs

class _ModuleUnpickler(pickle.Unpickler):
    """Unpickler that resolves classes through ``sys.modules`` before
    falling back to ``__import__``: a server's handler threads may run
    while the package's own import is still in progress in another
    thread, where a plain ``__import__`` would wait on the package's
    import lock; modules already loaded need no import machinery."""

    def find_class(self, module, name):
        m = sys.modules.get(module)
        if m is not None:
            return getattr(m, name)
        return super().find_class(module, name)


_LEN = struct.Struct("<Q")
_NBUF = struct.Struct("<I")

# pipelined-window size: how many requests may ride one socket
# unacknowledged; correlation ids pair replies to their waiters
_WINDOW = int(os.environ.get("MXTPU_PS_WINDOW", "8"))

_IOV_MAX = 512        # iovecs per sendmsg call (Linux caps at 1024)

# the same-process shortcut: a client whose server lives in this process
# skips socket and pickle and dispatches directly, under the same fault
# points as a wire request; MXTPU_PS_LOCAL=0 forces the wire
_LOCAL_ON = os.environ.get("MXTPU_PS_LOCAL", "1") != "0"
_LOCAL_SERVERS = {}        # "host:port" -> in-process server
_LOCAL_GUARD = threading.Lock()

# sockets a client opens to one server (each handled on its own server
# thread)
_CONNS_PER_SERVER = int(os.environ.get("MXTPU_PS_CONNS", "1"))

# the RPC layer's retry knobs: the per-call reply deadline, the retries
# after the first attempt, and the exponential backoff window between them
_REQUEST_TIMEOUT = float(os.environ.get("MXTPU_PS_TIMEOUT", "300"))
_RETRIES = int(os.environ.get("MXTPU_PS_RETRIES", "3"))
_BACKOFF = float(os.environ.get("MXTPU_PS_BACKOFF", "0.05"))
_BACKOFF_MAX = float(os.environ.get("MXTPU_PS_BACKOFF_MAX", "2.0"))
_RECONNECT_TIMEOUT = float(os.environ.get("MXTPU_PS_RECONNECT", "5"))
_DEAD_AFTER = int(os.environ.get("MXTPU_PS_DEAD_AFTER", "3"))


# the client's comms instruments: every _CommStats field is a registry
# series labelled by client instance, so the registry's snapshot and the
# client's stats() dict read the same counters (mxtpu's names and fields)
_KVC_COUNTERS = {
    "bytes_sent": _obs.counter(
        "kv.client.bytes_sent", "wire bytes sent", ("inst",)),
    "bytes_recv": _obs.counter(
        "kv.client.bytes_recv", "wire bytes received", ("inst",)),
    "frames_sent": _obs.counter(
        "kv.client.frames_sent", "wire frames sent", ("inst",)),
    "frames_recv": _obs.counter(
        "kv.client.frames_recv", "wire frames received", ("inst",)),
    "coalesced_frames": _obs.counter(
        "kv.client.coalesced_frames", "multi-key frames sent",
        ("inst",)),
    "coalesced_subs": _obs.counter(
        "kv.client.coalesced_subs", "sub-commands coalesced",
        ("inst",)),
    "retransmits": _obs.counter(
        "kv.client.retransmits", "request replays after a failure",
        ("inst",)),
    "local_reqs": _obs.counter(
        "kv.client.local_reqs", "same-process shortcut dispatches",
        ("inst",)),
    "map_reroutes": _obs.counter(
        "kv.client.map_reroutes", "map_stale reroutes followed",
        ("inst",)),
    "sparse_frames": _obs.counter(
        "kv.client.sparse_frames", "row-sparse wire frames",
        ("inst",)),
    "sparse_rows_sent": _obs.counter(
        "kv.client.sparse_rows_sent", "row-sparse rows shipped",
        ("inst",)),
}
_KVC_HWM = _obs.gauge("kv.client.inflight_hwm",
                      "pipelined-window in-flight high-water mark",
                      ("inst",))
_KVC_RPC_MS = _obs.histogram(
    "kv.client.rpc_ms", "client-observed request round-trip latency",
    ("op",))
_KVC_INST = itertools.count(1)


class _CommStats:
    """Worker-side comms counters behind ``kv.stats()``. Cheap enough to
    run unconditionally: one lock bump per frame, never per byte —
    each field IS a registry series (label ``inst=<n>``), so the same
    numbers surface in ``obs.REGISTRY.snapshot()`` / the ``metrics``
    wire op without a second bookkeeping path."""

    _FIELDS = ("bytes_sent", "bytes_recv", "frames_sent", "frames_recv",
               "coalesced_frames", "coalesced_subs", "retransmits",
               "inflight_hwm", "local_reqs", "map_reroutes",
               "sparse_frames", "sparse_rows_sent")

    def __init__(self):
        inst = "c%d" % next(_KVC_INST)
        self._c = {f: m.labels(inst) for f, m in _KVC_COUNTERS.items()}
        self._hwm = _KVC_HWM.labels(inst)

    def add(self, field, n=1):
        self._c[field].inc(n)

    def hwm(self, inflight):
        self._hwm.set_max(inflight)

    def snapshot(self):
        out = {f: s.value for f, s in self._c.items()}
        out["inflight_hwm"] = self._hwm.value
        return out

    def release(self):
        """Give the registry series back (store/client close): the
        local dict keeps working, the fleet snapshot forgets this
        instance."""
        for s in self._c.values():
            s.drop()
        self._hwm.drop()


def _sendmsg_all(sock, views):
    """Scatter-gather sendall: one ``sendmsg`` syscall moves the frame
    head and every raw buffer with no intermediate concatenation — the
    zero-copy send half. Sequential ``sendall`` fallback where sendmsg
    is missing (non-POSIX)."""
    views = [v for v in views if v.nbytes]
    if not hasattr(sock, "sendmsg"):
        for v in views:
            sock.sendall(v)
        return
    while views:
        sent = sock.sendmsg(views[:_IOV_MAX])
        while sent:
            if sent >= views[0].nbytes:
                sent -= views[0].nbytes
                views.pop(0)
            else:
                views[0] = views[0][sent:]
                sent = 0


def _send_frame(sock, obj, stats=None):
    """Pickle-5 framing with out-of-band buffers: numpy payloads ride as
    raw frames after the pickle body instead of being copied into it.
    Wire: u64 body_len, body, u32 n_buffers, u64 len x n, then the raw
    buffer bytes back to back. The whole frame leaves in one
    scatter-gather sendmsg — an N-byte gradient is never concatenated,
    and no tiny split segment exists to trip Nagle/delayed-ACK."""
    buffers = []
    body = pickle.dumps(obj, protocol=5, buffer_callback=buffers.append)
    raws = [buf.raw() for buf in buffers]
    head = (_LEN.pack(len(body)) + body + _NBUF.pack(len(raws))
            + b"".join(_LEN.pack(r.nbytes) for r in raws))
    _sendmsg_all(sock, [memoryview(head)] + raws)
    if stats is not None:
        stats.add("bytes_sent", len(head) + sum(r.nbytes for r in raws))
        stats.add("frames_sent")


def _recv_exact(sock, n):
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        try:
            # the one raw read: a server idles here unbounded (clients
            # hold connections open between requests); a client's socket
            # has a timeout, its receiver thread's poll tick
            r = sock.recv_into(view[got:], n - got)
        except socket.timeout:
            if got:
                # mid-frame stall: the stream position is lost and the
                # connection must not be reused (idle timeouts — got==0
                # — are the receiver thread's poll tick and harmless)
                raise ConnectionError(
                    "timed out mid-frame after %d/%d bytes" % (got, n))
            raise
        if not r:
            raise ConnectionError("peer closed")
        got += r
    return buf


_MAX_FRAME = 1 << 34   # 16 GiB: far above any real push, far below the
                       # garbage lengths a protocol mismatch produces


def _read_len(sock):
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if n > _MAX_FRAME:
        # e.g. a tokened client talking to a tokenless server: the raw
        # auth preamble parses as an absurd frame length — fail loudly
        # instead of blocking in _recv_exact forever
        raise ConnectionError(
            "oversized frame length %d — protocol mismatch (is "
            "MXTPU_PS_TOKEN set on one side only?)" % n)
    return n


def _recv_frame(sock, stats=None):
    body = _recv_exact(sock, _read_len(sock))
    (n_buf,) = _NBUF.unpack(_recv_exact(sock, _NBUF.size))
    if n_buf > 4096:
        raise ConnectionError("implausible buffer count %d" % n_buf)
    buffers, total = [], 0
    if n_buf:
        lens_raw = _recv_exact(sock, _LEN.size * n_buf)
        lens = [_LEN.unpack_from(lens_raw, i * _LEN.size)[0]
                for i in range(n_buf)]
        total = sum(lens)
        if any(n > _MAX_FRAME for n in lens) or total > _MAX_FRAME:
            raise ConnectionError(
                "oversized buffer length — protocol mismatch")
        # one blob, one recv_into stream: every out-of-band buffer of
        # the frame is a memoryview slice of it, so the payloads are
        # reconstructed zero-copy straight out of the wire buffer
        blob = memoryview(_recv_exact(sock, total))
        off = 0
        for n in lens:
            buffers.append(blob[off:off + n])
            off += n
    if stats is not None:
        stats.add("bytes_recv", _LEN.size + len(body) + _NBUF.size
                  + _LEN.size * n_buf + total)
        stats.add("frames_recv")
    return pickle.loads(body, buffers=buffers)


_AUTH_MAGIC = b"MXA1"


def _auth_blob(token):
    """Fixed-length raw preamble proving knowledge of the launch secret.
    Deliberately NOT a pickle frame: the point of auth is that no
    attacker-controlled bytes reach pickle.loads, so the check must
    happen on raw bytes before the first frame is read."""
    import hashlib
    return _AUTH_MAGIC + hashlib.sha256(token.encode("utf-8")).digest()



class _TCPServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True
    # socketserver's default accept backlog is 5: a burst of clients
    # overflows it and waits out a ~1 s TCP SYN retransmit
    request_queue_size = 1024
    dying = False    # set synchronously by the owner's stop()/kill():
    #                  serve_forever's shutdown poll is ~0.5 s, and a dead
    #                  server must refuse new conversations at once

    def verify_request(self, request, client_address):
        return not self.dying

    def process_request(self, request, client_address):
        request.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        super().process_request(request, client_address)




_IDEMPOTENT = frozenset(
    ("init", "push", "pushpull", "spush", "spushpull", "pull",
     "pull_rows", "stats", "ping",
     "set_optimizer", "opt_states", "set_opt_states", "multi",
     "hello", "bye", "repl", "promote", "peer_info", "join_backup",
     "peer_alive", "reconcile",
     "shard_map", "cursor_next", "cursor_done", "adopt_key", "split",
     "publish", "weights", "weight_sub", "metrics",
     "stream_push", "stream_offsets"))


class _Pending:
    """One in-flight request on a channel. ``on_partial`` (set before
    the frame is sent) receives streamed partial replies — frames
    tagged ``"+"`` that do NOT retire the pending slot; the terminal
    2-tuple reply still pairs and releases the window as always."""

    __slots__ = ("cid", "event", "reply", "error", "on_partial")

    def __init__(self, cid, on_partial=None):
        self.cid = cid
        self.event = threading.Event()
        self.reply = None
        self.error = None
        self.on_partial = on_partial


class _Channel:
    """One pipelined socket to a server: frames go out under a send lock
    stamped with correlation ids, a receiver thread pairs replies back
    to their waiters, and a bounded window (``MXTPU_PS_WINDOW``) caps
    how many requests ride unacknowledged. Any failure — socket error,
    injected sever, a waiter's deadline — kills the whole channel:
    every in-flight request fails with ConnectionError and the retry
    layer above replays exactly the unacked window (the push seq dedupe
    makes those replays at-most-once)."""

    def __init__(self, conn, sock, window):
        self._conn = conn
        self._sock = sock
        self._window = threading.Semaphore(window)
        self._pending = {}         # cid -> _Pending
        self._lock = threading.Lock()
        self._send_lock = threading.Lock()
        self._next_cid = itertools.count(1)
        self.dead = False
        self._err = None
        self._rx = threading.Thread(target=self._recv_loop, daemon=True,
                                    name="mxtpu-ps-rx")
        self._rx.start()

    def inflight(self):
        with self._lock:
            return len(self._pending)

    def submit(self, msg, timeout, on_partial=None):
        """Register a pending slot and send the frame; returns without
        waiting for the reply — up to the window size of these stream
        back to back on one socket. ``on_partial`` (if given) is called
        from the receiver thread with each streamed partial reply for
        this request; the terminal 2-tuple reply still pairs normally."""
        if not self._window.acquire(timeout=timeout):
            raise ConnectionError(
                "pipelined window stalled %.1fs on %s"
                % (timeout, self._conn.addr))
        p = _Pending(next(self._next_cid), on_partial=on_partial)
        with self._lock:
            if self.dead:
                self._window.release()
                raise ConnectionError("channel closed: %s" % (self._err,))
            self._pending[p.cid] = p
            self._conn._stats.hwm(len(self._pending))
        try:
            act = _fault.fire("worker.send", op=msg[0],
                              key=msg[1] if len(msg) > 1 else None,
                              sock=self._sock, addr=self._conn.addr)
            if act != "drop":      # dropped frame: the peer never sees
                # a sampled trace rides as a third frame element —
                # metadata only, absent (classic 2-tuple) when no
                # trace is active on this thread
                tctx = _obs.wire_ctx()
                frame = (p.cid, msg) if tctx is None \
                    else (p.cid, msg, tctx)
                with self._send_lock:   # it; the waiter's deadline fires
                    _send_frame(self._sock, frame,
                                stats=self._conn._stats)
        except BaseException as e:
            self.fail(e)
            raise
        return p

    def wait(self, p, msg, timeout):
        try:
            _fault.fire("worker.recv", op=msg[0],
                        key=msg[1] if len(msg) > 1 else None,
                        sock=self._sock, addr=self._conn.addr)
        except BaseException as e:
            self.fail(e)
            raise
        if not p.event.wait(timeout):
            # a silent reply (dropped frame, hung server) can only be
            # noticed here; the stream position may be anywhere, so the
            # whole channel dies and the window replays
            self.fail(ConnectionError(
                "no reply within %.1fs for %r from %s"
                % (timeout, msg[0], self._conn.addr)))
        if p.error is not None:
            raise p.error
        return p.reply

    def _recv_loop(self):
        while True:
            try:
                frame = _recv_frame(self._sock, stats=self._conn._stats)
            except socket.timeout:
                continue   # idle tick; waiters enforce their deadlines
            except BaseException as e:
                self.fail(e)
                return
            if isinstance(frame, tuple) and len(frame) == 3 \
                    and frame[2] == "+":
                # streamed partial: delivered to the pending slot's
                # callback without retiring it — the window stays held
                # until the terminal 2-tuple reply pairs.  A partial
                # for an unknown cid (caller already failed/timed out)
                # is dropped silently.
                with self._lock:
                    p = self._pending.get(frame[0])
                if p is not None and p.on_partial is not None:
                    try:
                        p.on_partial(frame[1])
                    except BaseException:
                        # an observer that raises must not tear the
                        # channel under the other requests in flight; the
                        # terminal reply still carries the full answer
                        pass
                continue
            if not isinstance(frame, tuple) or len(frame) != 2:
                self.fail(ConnectionError("unpaired reply frame"))
                return
            with self._lock:
                p = self._pending.pop(frame[0], None)
            if p is not None:
                p.reply = frame[1]
                p.event.set()
                self._window.release()

    def fail(self, err):
        """Tear the channel down once: close the socket, fail every
        pending waiter. Idempotent (the receiver, a failed submit and a
        timed-out waiter may all race here)."""
        with self._lock:
            if self.dead:
                return
            self.dead = True
            self._err = err
            pend = list(self._pending.values())
            self._pending.clear()
        try:
            # shutdown BEFORE close: close() alone defers the real fd
            # close while the receiver thread is blocked in recv() on
            # this socket, so the thread (and the server's handler for
            # this connection, which never sees our FIN) would linger
            # until the socket timeout ticks — hundreds of zombie
            # threads under a connection-churning load
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        for p in pend:
            p.error = ConnectionError(
                "connection to %s failed: %s: %s"
                % (self._conn.addr, type(err).__name__, err))
            p.event.set()
            self._window.release()


class _ServerConn:
    """One client's view of one server: a set of pipelined channels
    (``MXTPU_PS_CONNS`` sockets, each with a ``MXTPU_PS_WINDOW``-deep
    in-flight window), the retry/backoff RPC layer, and this client's
    health bookkeeping for the server: consecutive request/heartbeat
    failures past ``MXTPU_PS_DEAD_AFTER`` mark it ``dead``; any success
    marks it ``ok`` again."""

    def __init__(self, addr, connect_timeout=60.0, token=None,
                 n_socks=None, request_timeout=None, retries=None,
                 stats=None, window=None):
        self.addr = addr
        self._host, _, port = addr.partition(":")
        self._port = int(port)
        self._token = token
        self._timeout = _REQUEST_TIMEOUT if request_timeout is None \
            else float(request_timeout)
        self._retries = _RETRIES if retries is None else int(retries)
        self._window_n = max(1, _WINDOW if window is None else int(window))
        self._own_stats = stats is None   # release our registry series
        self._stats = stats if stats is not None else _CommStats()
        self.state = "ok"
        self.failures = 0          # consecutive failures
        self.last_error = None
        self.last_ping = {}        # the last ping reply's info dict
        self._health_lock = threading.Lock()
        n_socks = max(1, n_socks if n_socks is not None
                      else _CONNS_PER_SERVER)
        self._channels = [None] * n_socks
        self._ch_locks = [threading.Lock() for _ in range(n_socks)]
        self._rr = itertools.count()
        # eager first connect, retried with backoff until the deadline:
        # a replica process binds its port only after its warm-up, and
        # an unbound local port refuses at once. Extra channels connect
        # lazily.
        self._channels[0] = _Channel(
            self, self._connect(time.time() + connect_timeout),
            self._window_n)

    def _connect(self, deadline):
        delay = 0.1
        while True:
            try:
                s = socket.create_connection((self._host, self._port),
                                             timeout=self._timeout)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                break
            except OSError:
                if time.time() >= deadline:
                    raise
                time.sleep(delay)
                delay = min(delay * 2, 2.0)
        if self._token:
            s.sendall(_auth_blob(self._token))
        return s

    @property
    def n_socks(self):
        return len(self._channels)

    def _channel(self, i=None):
        """The channel for slot ``i`` (round-robin when unspecified),
        lazily (re)connected — a failed channel is never reused, its
        replacement gets a fresh socket (a stale reply must not
        mispair even across reconnects: cids are per-channel)."""
        if i is None:
            i = next(self._rr) % len(self._channels)
        with self._ch_locks[i]:
            ch = self._channels[i]
            if ch is None or ch.dead:
                ch = _Channel(
                    self, self._connect(time.time() + _RECONNECT_TIMEOUT),
                    self._window_n)
                self._channels[i] = ch
            return ch

    # -- health bookkeeping ----------------------------------------------
    def _note_ok(self):
        with self._health_lock:
            recovered = self.state == "dead"
            self.state = "ok"
            self.failures = 0
            self.last_error = None
        return recovered

    def _note_failure(self, err):
        with self._health_lock:
            self.failures += 1
            self.last_error = "%s: %s" % (type(err).__name__, err)
            if self.failures >= _DEAD_AFTER:
                self.state = "dead"

    def health(self):
        with self._health_lock:
            return {"addr": self.addr, "state": self.state,
                    "failures": self.failures,
                    "last_error": self.last_error}

    # -- the same-process shortcut ---------------------------------------
    def _local_srv(self):
        """The in-process server behind this address, if any. Its
        requests skip socket and pickle entirely: one direct
        ``_dispatch`` under the same fault points as a wire request
        (``MXTPU_PS_LOCAL=0`` forces the wire)."""
        if not _LOCAL_ON:
            return None
        return _LOCAL_SERVERS.get(self.addr)

    def _local_call(self, srv, msg, timeout):
        op = msg[0]
        key = msg[1] if len(msg) > 1 and isinstance(msg[1], (str, int)) \
            else None
        if srv._tcp.dying:
            raise ConnectionError(
                "in-process server %s is down" % self.addr)
        dropped = _fault.fire("worker.send", op=op, key=key,
                              addr=self.addr) == "drop"
        if not dropped:
            _fault.fire("server.recv", op=op, key=key, server=srv)
            reply = srv._dispatch(msg)
            if _fault.fire("server.send", op=op, key=key,
                           server=srv) != "drop":
                _fault.fire("worker.recv", op=op, key=key,
                            addr=self.addr)
                self._stats.add("local_reqs")
                return reply
        # a dropped request/reply frame is silent on the wire too:
        # only the per-call deadline notices, then the retry layer runs
        time.sleep(timeout)
        raise ConnectionError(
            "no reply within %.1fs for %r from %s"
            % (timeout, op, self.addr))

    # -- the RPC layer ---------------------------------------------------
    def _backoff_delay(self, attempt):
        # bounded exponential backoff with DETERMINISTIC per-server
        # jitter: crc32(addr:attempt) spreads a fleet's retries without
        # randomness (the fault tests replay exact schedules)
        base = min(_BACKOFF * (2 ** attempt), _BACKOFF_MAX)
        j = zlib.crc32(("%s:%d" % (self.addr, attempt)).encode()) % 256
        return base * (1.0 + j / 1024.0)

    def request(self, *msg, **kw):
        """Send one command and return its reply, retrying idempotent
        commands through connection faults with bounded exponential
        backoff. ``timeout=`` overrides the per-call reply deadline
        (heartbeats probe with a short one). A sampled trace on this
        thread records the whole call (retries included) as a
        ``kv.client.rpc`` span."""
        if _obs.active_ctx() is None:
            return self._request_impl(msg, kw)
        with _obs.span("kv.client.rpc", op=msg[0], addr=self.addr):
            return self._request_impl(msg, kw)

    def _request_impl(self, msg, kw):
        timeout = kw.pop("timeout", None)
        retries = kw.pop("retries", None)
        assert not kw, kw
        timeout = self._timeout if timeout is None else timeout
        if retries is None:
            retries = self._retries if msg[0] in _IDEMPOTENT else 0
        last = None
        t0 = time.perf_counter()
        for attempt in range(retries + 1):
            if attempt:
                self._stats.add("retransmits")
                time.sleep(self._backoff_delay(attempt - 1))
            try:
                srv = self._local_srv()
                if srv is not None:
                    reply = self._local_call(srv, msg, timeout)
                else:
                    ch = self._channel()
                    reply = ch.wait(ch.submit(msg, timeout), msg, timeout)
            except (ConnectionError, EOFError, OSError) as e:
                last = e
                self._note_failure(e)
                continue
            self._note_ok()
            _KVC_RPC_MS.labels(msg[0]).observe(
                (time.perf_counter() - t0) * 1e3)
            if reply[0] == "err":
                raise RuntimeError("server: %s" % reply[1])
            return reply
        # _note_failure counted every attempt, so an exhausted retry
        # budget >= MXTPU_PS_DEAD_AFTER already flipped state to dead;
        # a single failed probe (retries=0) only increments the count
        raise ConnectionError(
            "server %s unreachable during %r after %d "
            "attempt(s): %s (a close right after connect usually means "
            "MXTPU_PS_TOKEN does not match between this client and the "
            "server)" % (self.addr, msg[0], retries + 1, last)) from last

    def stream(self, *msg, **kw):
        """Send one command whose reply is a STREAM: zero or more
        partial frames (tagged ``"+"`` on the wire, delivered to
        ``on_partial`` from the receiver thread) followed by one
        terminal reply, which is returned. Never retried here — a
        partially-streamed command is not idempotent at this layer;
        the caller replays with its own dedupe (the serving client
        pins the weight version and dedupes tokens by index)."""
        on_partial = kw.pop("on_partial", None)
        timeout = kw.pop("timeout", None)
        assert not kw, kw
        timeout = self._timeout if timeout is None else timeout
        t0 = time.perf_counter()
        try:
            srv = self._local_srv()
            if srv is not None:
                reply = self._local_stream(srv, msg, timeout, on_partial)
            else:
                ch = self._channel()
                p = ch.submit(msg, timeout, on_partial=on_partial)
                reply = ch.wait(p, msg, timeout)
        except (ConnectionError, EOFError, OSError) as e:
            self._note_failure(e)
            raise
        self._note_ok()
        _KVC_RPC_MS.labels(msg[0]).observe(
            (time.perf_counter() - t0) * 1e3)
        if reply[0] == "err":
            raise RuntimeError("server: %s" % reply[1])
        return reply

    def _local_stream(self, srv, msg, timeout, on_partial):
        """In-process mirror of :meth:`stream`, with the same fault
        points as ``_local_call`` plus one ``server.send`` fire per
        partial frame (a dropped partial is silently skipped, exactly
        like a dropped wire frame — the client recovers the token from
        the terminal reply)."""
        op = msg[0]
        key = msg[1] if len(msg) > 1 and isinstance(msg[1], (str, int)) \
            else None
        if srv._tcp.dying:
            raise ConnectionError(
                "in-process server %s is down" % self.addr)
        dropped = _fault.fire("worker.send", op=op, key=key,
                              addr=self.addr) == "drop"
        if not dropped:
            _fault.fire("server.recv", op=op, key=key, server=srv)

            def emit(partial):
                if on_partial is None:
                    return
                if _fault.fire("server.send", op=op, key=key,
                               server=srv) == "drop":
                    return
                on_partial(partial)

            reply = srv._dispatch_stream(msg, emit)
            if _fault.fire("server.send", op=op, key=key,
                           server=srv) != "drop":
                _fault.fire("worker.recv", op=op, key=key)
                self._stats.add("local_reqs")
                return reply
        time.sleep(timeout)
        raise ConnectionError(
            "no reply within %.1fs for %r from %s"
            % (timeout, op, self.addr))

    def ping(self, timeout=2.0, origin=None):
        """One heartbeat probe: no retries, short timeout. The probe
        rides its own correlation id on the pipelined channel, so it
        never interleaves with a transfer in flight; when traffic is in
        flight the server is alive by definition and no probe is sent.
        ``origin`` rides along (a server may key a lease on it)."""
        for ch in self._channels:
            if ch is not None and not ch.dead and ch.inflight():
                return True
        try:
            if origin is not None:
                reply = self.request("ping", origin, timeout=timeout,
                                     retries=0)
            else:
                reply = self.request("ping", timeout=timeout, retries=0)
            if len(reply) > 1 and isinstance(reply[1], dict):
                self.last_ping = reply[1]
            return True
        except (ConnectionError, OSError):
            return False

    def close(self):
        for ch in self._channels:
            if ch is not None:
                ch.fail(ConnectionError("store closed"))
        if self._own_stats:
            self._stats.release()


