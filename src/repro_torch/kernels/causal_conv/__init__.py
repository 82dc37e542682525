"""The Mamba2 mixer's depthwise causal conv1d with its bias and SiLU:
plain versions (``ref``), CUDA kernels (``causal_conv``) and routing
(``ops``)."""
