"""Minimal XSpace (xplane.pb) reader: per-kernel device-time totals.

``jax.profiler`` writes traces as an ``XSpace`` protobuf. Per-kernel device
time is read by walking the wire format directly — no protobuf runtime,
schema or profiler plug-in needed. Only the fields used are decoded
(XSpace.planes=1; XPlane.name=2, lines=3, event_metadata=4; XLine.events=4;
XEvent.metadata_id=1, duration_ps=3; XEventMetadata.id=1, name=2), which is
stable across TF/JAX xplane versions.

A trace of the train step taken on an H100 (benchmarks/profile_step.py)
holds one plane per card, ``/device:GPU:<i>``, with one line per CUDA
stream: ``Stream #13(Memset,MemcpyD2D,Compute)`` carries every kernel, and
``Stream #14(MemcpyH2D)`` / ``Stream #15(MemcpyD2H)`` the host transfers.
Host planes (``/host:CPU``, ``/host:metadata``) hold the Python and runtime
threads.
"""

from __future__ import annotations

import collections
import glob
import os
from typing import Iterator, Optional, Tuple, Union

# Defaults: the card's device plane, and the stream lines that run kernels
# (not the host-transfer streams).
DEVICE_PLANE = "/device:GPU:"
KERNEL_LINES = "Compute"


def _varint(buf: bytes, i: int) -> Tuple[int, int]:
    r = 0
    s = 0
    while True:
        b = buf[i]
        i += 1
        r |= (b & 0x7F) << s
        if not b & 0x80:
            return r, i
        s += 7


def _fields(buf: bytes) -> Iterator[Tuple[int, int, Union[int, bytes]]]:
    """Yield (field_number, wire_type, value) over a message's wire bytes."""
    i, n = 0, len(buf)
    while i < n:
        tag, i = _varint(buf, i)
        fnum, wt = tag >> 3, tag & 7
        if wt == 0:  # varint
            v, i = _varint(buf, i)
            yield fnum, wt, v
        elif wt == 2:  # length-delimited
            ln, i = _varint(buf, i)
            yield fnum, wt, buf[i : i + ln]
            i += ln
        elif wt == 5:  # 32-bit
            yield fnum, wt, buf[i : i + 4]
            i += 4
        elif wt == 1:  # 64-bit
            yield fnum, wt, buf[i : i + 8]
            i += 8
        else:  # unknown/deprecated group — cannot skip safely
            return


def _planes(data: bytes) -> Iterator[Tuple[str, dict, list]]:
    """Yield (plane name, {metadata id: event name}, [line bytes])."""
    for f, wt, plane in _fields(data):
        if f != 1 or wt != 2:  # XSpace.planes
            continue
        name = b""
        ev_meta: dict[int, str] = {}
        lines = []
        for pf, pwt, pv in _fields(plane):
            if pf == 2 and pwt == 2:
                name = pv
            elif pf == 3 and pwt == 2:
                lines.append(pv)
            elif pf == 4 and pwt == 2:
                # map<int64, XEventMetadata> entry: key=1, value=2{id=1,name=2}
                k = None
                v = None
                for mf, _, mv in _fields(pv):
                    if mf == 1:
                        k = mv
                    elif mf == 2:
                        for ef, _, evv in _fields(mv):
                            if ef == 2:
                                v = evv
                if k is not None:
                    ev_meta[k] = (v or b"?").decode("utf-8", "replace")
        yield name.decode("utf-8", "replace"), ev_meta, lines


def _line(ln: bytes) -> Tuple[str, list]:
    """(line name, [event bytes])."""
    lname = b""
    events = []
    for lf, lwt, lv in _fields(ln):
        if lf == 2 and lwt == 2:  # XLine.name
            lname = lv
        elif lf == 4 and lwt == 2:  # XLine.events
            events.append(lv)
    return lname.decode("utf-8", "replace"), events


def plane_inventory(data: bytes) -> dict[str, dict[str, int]]:
    """{plane name: {line name: event count}} — what a trace holds."""
    return {
        name: {lname: len(events) for lname, events in map(_line, lines)}
        for name, _, lines in _planes(data)
    }


def plane_kernel_totals(
    data: bytes,
    plane_filter: str = DEVICE_PLANE,
    line_filter: Optional[str] = KERNEL_LINES,
) -> dict[str, int]:
    """Sum event duration_ps per event name over the matching planes.

    Returns {kernel_name: total_picoseconds} across every plane whose name
    contains ``plane_filter`` (case-insensitive), counting only lines whose
    name contains ``line_filter`` (None: every line). The default keeps the
    kernel stream and leaves out the host-transfer streams.
    """
    totals: collections.Counter = collections.Counter()
    for name, ev_meta, lines in _planes(data):
        if plane_filter.lower() not in name.lower():
            continue
        for lname, events in map(_line, lines):
            if line_filter is not None and line_filter not in lname:
                continue
            for lv in events:
                meta_id = None
                dur = 0
                for ef, _, ev in _fields(lv):
                    if ef == 1:
                        meta_id = ev
                    elif ef == 3:
                        dur = ev  # duration_ps
                if meta_id is not None:
                    totals[ev_meta.get(meta_id, str(meta_id))] += dur
    return dict(totals)


def latest_xplane_pb(logdir: str) -> str:
    """The newest ``*.xplane.pb`` under a jax.profiler trace logdir."""
    paths = glob.glob(
        os.path.join(logdir, "**", "*.xplane.pb"), recursive=True
    )
    if not paths:
        raise FileNotFoundError(f"no xplane.pb under {logdir}")
    return max(paths, key=os.path.getmtime)


def kernel_report(
    logdir: str,
    n_steps: int,
    top: int = 40,
    plane_filter: str = DEVICE_PLANE,
    line_filter: Optional[str] = KERNEL_LINES,
) -> list[tuple[str, float]]:
    """[(kernel_name, device_ms_per_step)] for the newest trace in logdir."""
    with open(latest_xplane_pb(logdir), "rb") as f:
        totals = plane_kernel_totals(f.read(), plane_filter, line_filter)
    rows = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    return [(name, ps / 1e9 / max(1, n_steps)) for name, ps in rows]
