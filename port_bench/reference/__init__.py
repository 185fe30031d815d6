"""The plain reference: plain PyTorch that imports nothing of
cugraph_tpu_torch and works out again, from the generated edge list, the
graph the port built and each query's answer."""
