"""Port OversegParams: same fields and defaults as the JAX package's, and
`params_from_jax` round-trips (from the NamedTuple and from `_asdict()`
with numpy values)."""

import numpy as np
import pytest
import torch

from video_segment_tpu.core import oversegmentation as jov
from video_segment_tpu_torch.core import oversegmentation as tov

torch.set_num_threads(2)


def test_fields_and_defaults_match():
    assert tov.OversegParams._fields == jov.OversegParams._fields
    assert tov.OversegParams._field_defaults == \
        jov.OversegParams._field_defaults
    assert tuple(tov.OversegParams()) == tuple(jov.OversegParams())


@pytest.mark.parametrize("as_dict", [False, True], ids=["tuple", "asdict"])
def test_params_from_jax_round_trips(as_dict):
    pj = jov.OversegParams(min_region_size=77, schedule=(4, 64, 2047),
                           table_divisor=16, preseg_rounds_per_level=(3, 2, 1),
                           extract_tile=False, metric="l1")
    src = pj
    if as_dict:
        src = {k: (np.asarray(v) if isinstance(v, (tuple, int, float))
                   and not isinstance(v, bool) else v)
               for k, v in pj._asdict().items()}
    pt = tov.params_from_jax(src)
    assert isinstance(pt, tov.OversegParams)
    assert tuple(pt) == tuple(pj)
    assert all(type(a) is type(b) for a, b in zip(pt, pj))
