"""Storage formats: the host CSR import format (numpy) and the DIA device
format (a torch tensor in the interleaved lane layout)."""
