"""File sources and sinks (``spark_rapids_tpu/io`` counterpart)."""
