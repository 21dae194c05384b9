"""The bounded-trace cases of ``torch_bounded_cases.py`` (K1d's function,
``render.trace_tiles_bounded`` and ``render.trace_tiles_temporal`` against
the port's unbounded trace, bit for bit) on the JAX package's K = 1 LBVH tree (4 slots).
"""

from torch_parity import one_torch_thread  # noqa: F401
from torch_bounded_cases import (records_fixture,
                                 test_bounded_equals_unbounded,
                                 test_bounded_equals_unbounded_with_background,
                                 test_temporal_equals_the_jittered_trace,
                                 test_no_bounds_and_root_entries_change_nothing,
                                 test_bounds_cut_exactly_the_hits_beyond_them,
                                 test_bad_arguments_raise)  # noqa: F401

records = records_fixture("k1", 4)
