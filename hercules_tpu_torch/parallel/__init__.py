"""Multi-chip paths of the port: the slab and sharded decompositions on
a list of ranks in one process (``ranks.RankGroup``), their driver and
their communication model.  Counterpart of ``hercules_tpu/parallel/``;
the graded paths (gslab, gmesh) and the multi-process shape
(multihost, shardbuild) are not ported yet (ROADMAP Queue 1, items 8b
and 8c).  Importing the package builds no kernel."""
