"""Device compute of the port.  Import the submodules themselves:
this package imports nothing on its own, so ``import
ld_tools_tpu_torch.ops.exact`` never pulls in torch or the kernels."""
