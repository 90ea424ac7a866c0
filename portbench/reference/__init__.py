"""Plain references of the benchmark's model families: float32 PyTorch,
no kernel, no cache, no batching. They import neither JAX, the JAX
package, nor anything of the program: the benchmark hands them its own
weights and the tokens to judge."""
