"""Data pipeline of the port (numpy only, shared batches with the JAX
package)."""
