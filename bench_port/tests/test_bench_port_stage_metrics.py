"""The span readers (`metrics/<name>.py` over `metrics/_stage.py`): each
reads its span's milliseconds a frame from a run's records, and nothing
where the program has no such span (a parent commit without it)."""

import importlib

import pytest

SPANS = {
    "region_features_ms_per_frame": "region.features",
    "region_accumulate_ms_per_frame": "region.accumulate",
    "region_tables_ms_per_frame": "region.tables",
    "region_upload_ms_per_frame": "region.upload",
    "region_levels_ms_per_frame": "region.levels",
    "region_hierarchy_ms_per_frame": "region.hierarchy",
    "region_emit_ms_per_frame": "region.emit",
    "tail_compact_ms_per_frame": "host_tail.compact",
    "tail_connect_ms_per_frame": "host_tail.connect",
    "tail_ids_ms_per_frame": "host_tail.ids",
    "tail_rle_ms_per_frame": "host_tail.rle",
}


@pytest.mark.parametrize("name", sorted(SPANS))
def test_span_reader(name):
    read = importlib.import_module(f"bench_port.metrics.{name}").read
    others = {k: 9.0 for k in SPANS.values() if k != SPANS[name]}
    rec = {"stage_seconds": {"region": 6.3, "host_tail": 1.8, **others,
                             SPANS[name]: 0.7},
           "stage_frames": 560}
    assert read(rec) == pytest.approx(1.25)
    del rec["stage_seconds"][SPANS[name]]
    assert read(rec) is None
    assert read({"stage_seconds": {SPANS[name]: 0.7}, "stage_frames": 0}) \
        is None
    assert read({}) is None
