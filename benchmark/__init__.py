"""The benchmark of ``keystone_tpu_torch`` on one H100.

``python3 -m benchmark.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything that belongs to one configuration, traffic mix or
metric sits in a file of its own, found by the name the manifest gives:

* ``configs/<config>.json``: the sizes as run, their source, what was cut;
* ``inputs/<config>.py``: the data (and random weights) drawn on the card
  from the seed;
* ``apps/<config>.py``: the calls into the port's own entry points;
* ``reference/<config>.py``: the plain float64 reference, which imports
  nothing of the port;
* ``counts/<config>.py``: the operations the mathematics needs, from shapes;
* ``traffic/<mix>.json``: a mix's parameters, and its ``kind``;
* ``loops/<kind>.py``: the loop that drives the window for every mix of
  that kind (set-up's warm-up, the window, the operations it did);
* ``controls/<name>.py``: a lower precision put in the program's place,
  which must come out not correct (``benchmark/calibrate.py``);
* ``metrics/<metric>.py``: the reader of one metric;
* ``limits/<workload>.json``: the numbers compared with the reference and
  their limits.

Nothing here imports ``jax`` or the JAX package ``keystone_tpu``.
"""
