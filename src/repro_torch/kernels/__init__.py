"""Hand-written Hopper kernels, their plain versions, and the dispatcher."""
