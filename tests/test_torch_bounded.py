"""The bounded-trace cases of ``torch_bounded_cases.py`` (K1d's function,
``render.trace_tiles_bounded`` and ``render.trace_tiles_temporal`` against
the port's unbounded trace, bit for bit) on the port's K = 8 SAH tree at 4 slots.
"""

from torch_bounded_cases import (records_fixture,
                                 test_bounded_equals_unbounded,
                                 test_bounded_equals_unbounded_with_background,
                                 test_temporal_equals_the_jittered_trace,
                                 test_no_bounds_and_root_entries_change_nothing,
                                 test_bounds_cut_exactly_the_hits_beyond_them,
                                 test_bad_arguments_raise)  # noqa: F401

records = records_fixture("k8", 4)
