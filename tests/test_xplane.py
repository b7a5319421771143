"""utils/xplane wire-format reader against hand-encoded XSpace protos shaped
like an H100 trace."""

from bert4clickpath.utils.xplane import kernel_report, plane_inventory, plane_kernel_totals


def _varint(v: int) -> bytes:
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _field(fnum: int, wt: int, payload) -> bytes:
    tag = _varint((fnum << 3) | wt)
    if wt == 0:
        return tag + _varint(payload)
    return tag + _varint(len(payload)) + payload


def _event(meta_id: int, dur_ps: int) -> bytes:
    return _field(1, 0, meta_id) + _field(3, 0, dur_ps)


def _meta_entry(meta_id: int, name: bytes) -> bytes:
    meta = _field(1, 0, meta_id) + _field(2, 2, name)
    return _field(1, 0, meta_id) + _field(2, 2, meta)


def _line(events, name: bytes = b"") -> bytes:
    body = _field(2, 2, name) if name else b""
    return body + b"".join(_field(4, 2, _event(m, d)) for m, d in events)


def _plane(name: bytes, metas, events, extra_lines=()) -> bytes:
    body = _field(2, 2, name)
    body += _field(3, 2, _line(events))
    for ln in extra_lines:
        body += _field(3, 2, ln)
    for mid, mname in metas:
        body += _field(4, 2, _meta_entry(mid, mname))
    return _field(1, 2, body)


# Plane and line names as an H100 trace of the train step carries them
# (benchmarks/profile_step.py).
GPU0 = b"/device:GPU:0"
COMPUTE = b"Stream #13(Memset,MemcpyD2D,Compute)"
H2D = b"Stream #14(MemcpyH2D)"
D2H = b"Stream #15(MemcpyD2H)"


def test_plane_kernel_totals_sums_durations():
    space = _plane(
        GPU0,
        [(7, b"fused_ce_dw"), (9, b"gemm_fusion_dot_205")],
        [],
        extra_lines=[_line([(7, 1000), (7, 500), (9, 2000)], name=COMPUTE)],
    ) + _plane(
        # host plane must be excluded by the filter
        b"/host:CPU",
        [(1, b"python")],
        [],
        extra_lines=[_line([(1, 99999)], name=b"python")],
    )
    totals = plane_kernel_totals(space)
    assert totals == {"fused_ce_dw": 1500, "gemm_fusion_dot_205": 2000}


def test_unknown_metadata_id_falls_back_to_str():
    space = _plane(GPU0, [], [], extra_lines=[_line([(42, 777)], name=COMPUTE)])
    assert plane_kernel_totals(space) == {"42": 777}


def test_overlapping_lines_not_double_counted():
    # The transfer streams are device time too, but not kernels: only the
    # compute stream counts by default; every line counts with no filter.
    space = _plane(
        GPU0,
        [(1, b"MemcpyH2D"), (2, b"MemcpyD2H"), (3, b"loop_add_fusion_7")],
        [],
        extra_lines=[
            _line([(1, 500_000)], name=H2D),
            _line([(2, 300_000)], name=D2H),
            _line([(3, 400_000)], name=COMPUTE),
        ],
    )
    assert plane_kernel_totals(space) == {"loop_add_fusion_7": 400_000}
    assert sum(plane_kernel_totals(space, line_filter=None).values()) == 1_200_000


def test_every_card_plane_counts():
    space = b"".join(
        _plane(f"/device:GPU:{i}".encode(), [(1, b"fused_ce_fwd")], [],
               extra_lines=[_line([(1, 100 * (i + 1))], name=COMPUTE)])
        for i in range(4)
    )
    assert plane_kernel_totals(space) == {"fused_ce_fwd": 1000}


def test_no_device_plane_yields_nothing():
    """A trace without a GPU plane (e.g. taken on the CPU) gives no kernel
    time — profile_step.py then fails instead of reporting host time."""
    space = _plane(b"/host:CPU", [(1, b"python")], [],
                   extra_lines=[_line([(1, 5)], name=b"python")])
    assert plane_kernel_totals(space) == {}
    inventory = plane_inventory(space)
    assert list(inventory) == ["/host:CPU"] and inventory["/host:CPU"]["python"] == 1


def test_kernel_report_per_step(tmp_path):
    space = _plane(GPU0, [(1, b"fused_ce_dx"), (2, b"nvjet_tst")], [],
                   extra_lines=[_line([(1, 3_000_000_000), (2, 1_000_000_000)], name=COMPUTE)])
    d = tmp_path / "plugins" / "profile" / "run"
    d.mkdir(parents=True)
    (d / "host.xplane.pb").write_bytes(space)
    assert kernel_report(str(tmp_path), n_steps=10) == [("fused_ce_dx", 0.3), ("nvjet_tst", 0.1)]
