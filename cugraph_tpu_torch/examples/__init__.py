"""Example scripts, run as ``python -m cugraph_tpu_torch.examples.<name>``:
``train_graphsage`` (minibatch GraphSAGE training) and
``community_detection`` (Louvain, Leiden, ECG and triangles)."""
