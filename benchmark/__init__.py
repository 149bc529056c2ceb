"""The benchmark of linna_tpu_torch on one H100: see README.md."""
