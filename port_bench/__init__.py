"""The benchmark of cugraph_tpu_torch: one cell is a configuration (a graph
deployment, ``configs/``) under one traffic mix (``traffic/``). See
README.md."""
