"""Distributed execution (``spark_rapids_tpu/parallel/`` counterpart):
the mesh exchange (``exchange.py``), plan fragments run shard by shard
over a device mesh (``spmd.py``, ``shuffle.mode=ICI``), the one-step
distributed aggregate (``distributed.py``) and the host-staged shuffle
(``host_shuffle.py``, ``shuffle.mode=HOST``).  Multi-process ranks
(the reference's ``dcn.py``) are not ported."""
