"""Core numerics: precision policies, BFP quantization, GEMM dispatch."""
