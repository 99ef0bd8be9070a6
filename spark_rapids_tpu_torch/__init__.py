"""spark_rapids_tpu_torch: the PyTorch/CUDA port of spark_rapids_tpu.

The same Spark-semantics DataFrame engine as ``spark_rapids_tpu``, with
columns in torch tensors on an NVIDIA H100 and the device kernels written
by hand in CUDA C++ (``csrc/``).  It imports torch and numpy, never JAX or
the JAX package, and runs on the CUDA card unless the caller asks for the
CPU (``device="cpu"``).

Quick start::

    import spark_rapids_tpu_torch as srt
    from spark_rapids_tpu_torch.models import tpch
    sess = srt.Session.get_or_create()          # the CUDA card
    df = sess.create_dataframe(tpch.gen_lineitem_arrays(1.0))
    print(tpch.q6(df).collect())
"""

from .sql.session import Session  # noqa: F401
from .sql.column import Column  # noqa: F401
from .sql import functions  # noqa: F401
from . import types  # noqa: F401

__version__ = "0.1.0"
