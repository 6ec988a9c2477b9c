"""Distributed linear algebra on torch tensors (port of
``keystone_tpu/linalg/``, which replaces the reference's external mlmatrix
package: RowPartitionedMatrix, NormalEquations, BlockCoordinateDescent,
TSQR)."""

from .row_matrix import RowShardedMatrix, cross, gram, solve_spd
from .normal_equations import (
    gram_accumulate,
    solve_least_squares,
    solve_least_squares_streaming,
    solve_least_squares_with_intercept,
)
from .bcd import (
    solve_blockwise_l2,
    solve_blockwise_l2_scan,
    solve_blockwise_l2_streaming,
    stream_column_means,
)
from .tsqr import tsqr_r, tsqr_r_streaming
from .accumulators import GramSolverState, MomentsState, NotAbsorbable, TsqrRState
from .weighted import WeightedSolverState, solve_weighted_streaming

__all__ = [
    "GramSolverState",
    "MomentsState",
    "NotAbsorbable",
    "TsqrRState",
    "WeightedSolverState",
    "RowShardedMatrix",
    "gram",
    "cross",
    "solve_spd",
    "solve_least_squares",
    "solve_least_squares_streaming",
    "gram_accumulate",
    "solve_least_squares_with_intercept",
    "solve_blockwise_l2",
    "solve_blockwise_l2_scan",
    "solve_blockwise_l2_streaming",
    "solve_weighted_streaming",
    "stream_column_means",
    "tsqr_r",
    "tsqr_r_streaming",
]
