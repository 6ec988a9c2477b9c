"""Solver cost models (port of ``keystone_tpu/nodes/learning/cost.py``;
parity: ``nodes/learning/CostModel.scala`` and the fitted cluster
constants of ``LeastSquaresEstimator.scala:28-31``).

The functional form ``max(cpu·flops, mem·bytes) + net·network`` carries
over unchanged. The default weights are the JAX package's; only their
ratios decide a choice. The number of machines is 1 until the port runs on
more than one device.
"""

from __future__ import annotations


class CostModel:
    """Estimated cost of fitting this solver on (n, d, k) data, in the
    analytic units ``cost`` returns."""

    #: True when ``fit`` accepts an out-of-core chunked dataset
    supports_streaming = False

    def cost(self, n: int, d: int, k: int, sparsity: float, num_machines: int,
             cpu_weight: float, mem_weight: float, network_weight: float) -> float:
        raise NotImplementedError


def combine_cost(signature: dict, cpu_weight: float, mem_weight: float,
                 network_weight: float) -> float:
    """``max(cpu·flops, mem·bytes) + net·network`` over one solver's work
    terms."""
    return (
        max(cpu_weight * signature["flops"], mem_weight * signature["bytes"])
        + network_weight * signature["network"]
    )


DEFAULT_CPU_WEIGHT = 2.5e-12
DEFAULT_MEM_WEIGHT = 1.2e-9
DEFAULT_NETWORK_WEIGHT = 2.2e-11


def dense_shape_from_samples(samples, num_items: int, machines: int,
                             chunked: bool = False):
    """(data, labels) dependency samples as the chooser's
    :class:`~keystone_tpu_torch.cost.ShapeSignature` of a dense solve: n is
    the FULL dataset size, d and k are read off one sample item."""
    from ...cost import ShapeSignature
    from ...data.dataset import Dataset

    sample = Dataset.of(samples[0])
    sample_labels = Dataset.of(samples[1])
    d = int(sample.first().shape[-1])
    k = int(sample_labels.first().shape[-1])
    n = num_items if num_items else len(sample)
    return ShapeSignature(n=int(n), d=d, k=k, chunked=bool(chunked), machines=int(machines))


def label_dim_fitted_out_spec(fit_in, apply_in):
    """The ``fitted_out_spec`` of the label-estimator solver families
    (``check/abstract.py``): the fitted mapper sends a feature vector to one
    score per label column, so the output's item spec is the labels' item
    shape, in float32. None when the labels' spec is unknown."""
    labels = fit_in[1] if len(fit_in) > 1 else None
    if not isinstance(labels, tuple) or len(labels) != 2 or not isinstance(labels[1], str):
        return None
    return (tuple(labels[0]), "float32")


class AutoSolverFrontDoor:
    """The cost-model front door of an auto-selecting estimator family: an
    ``options`` list of interchangeable solvers, selection through
    :class:`~keystone_tpu_torch.cost.SolverChooser`, and the graph-level
    ``sample_optimize`` hook.

    A subclass ``__init__`` sets ``self.options``, ``self.default`` and
    ``self.num_machines`` and calls :meth:`_init_chooser_weights`. ``cost``
    prices the front door as its cheapest option."""

    def fitted_out_spec(self, fit_in, apply_in):
        return label_dim_fitted_out_spec(fit_in, apply_in)

    def _init_chooser_weights(self, cpu_weight, mem_weight, network_weight):
        self.cpu_weight = DEFAULT_CPU_WEIGHT if cpu_weight is None else cpu_weight
        self.mem_weight = DEFAULT_MEM_WEIGHT if mem_weight is None else mem_weight
        self.network_weight = (
            DEFAULT_NETWORK_WEIGHT if network_weight is None else network_weight
        )

    def cost(self, n, d, k, sparsity, num_machines,
             cpu_weight, mem_weight, network_weight):
        return min(
            opt.cost(n, d, k, sparsity, num_machines, cpu_weight, mem_weight, network_weight)
            for opt in self.options
        )

    def shape_from_samples(self, samples, num_items: int, chunked: bool = False):
        return dense_shape_from_samples(samples, num_items, self.num_machines or 1, chunked)

    def choose_solver(self, shape, node_id=None):
        """The chooser's :class:`~keystone_tpu_torch.cost.SolverChoice`
        (pricing table included) over the options for ``shape``; with a
        profile store the prices are learned seconds (``cost/model.py``).
        ``node_id`` names the DAG node in the trace's estimate rows."""
        from ...cost import SolverChooser

        return SolverChooser().choose(
            self.options, shape, self.cpu_weight, self.mem_weight, self.network_weight,
            node_id=node_id, owner_label=type(self).__name__,
        )

    def sample_optimize(self, samples, num_items: int, chunked: bool = False):
        shape = self.shape_from_samples(samples, num_items, chunked=chunked)
        return self.choose_solver(shape).chosen
