"""Quantized ops: quant primitives, the quantized GEMM, conv, functional."""
