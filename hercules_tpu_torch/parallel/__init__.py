"""Multi-chip paths of the port: the slab, gslab, gmesh and sharded
decompositions on a group of ranks (``ranks.RankGroup`` in one process,
``ranks.DistRankGroup`` over the processes of a ``torch.distributed``
group), their driver, their communication model, and the multi-process
launcher (``multihost``, with the shard-local slab tables of
``shardbuild``).  Counterpart of ``hercules_tpu/parallel/``.  Importing
the package builds no kernel."""
