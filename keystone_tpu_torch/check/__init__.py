"""Static checks of a pipeline graph (port of the traceability lattice of
``keystone_tpu/check/``; the rest of that package is later work)."""
