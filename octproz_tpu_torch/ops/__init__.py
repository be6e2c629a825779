"""Signal-processing stages of the folded-GEMM path (torch and host numpy)."""
