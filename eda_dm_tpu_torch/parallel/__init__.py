"""Data and tensor parallelism on ``torch.distributed`` (port of
``eda_dm_tpu/parallel/``).

The JAX package gets its parallelism from GSPMD: inputs carry shardings,
a traced function sees the global shapes and XLA inserts the collectives.
Here each rank holds local tensors and calls the collectives itself:

* :mod:`.launch` starts one process a rank (``spawn``);
* :mod:`.mesh` builds the device mesh and moves rows and weights
  (``make_mesh``, ``shard_batch``, ``replicate``, ``gather_batch``);
* :mod:`.rows` says which rows of a global batch this process holds, so
  that batch sizes, random draws and calibration statistics are those of
  the global batch;
* :mod:`.spatial` says which rows of the height this process holds
  (``tp.shard_spatial``), and the layers exchange their conv halos, reduce
  their norms' sums and gather around attention through it;
* :mod:`.comm` holds the collectives (gloo stages card tensors through the
  host);
* :mod:`.dp` and :mod:`.tp` are the JAX package's ``dp_*`` and ``tp_*``.

Only :mod:`.rows`, :mod:`.spatial` and :mod:`.comm` are imported by the
model code; the others import the models.
"""
