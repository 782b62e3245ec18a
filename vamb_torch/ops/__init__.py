"""Host-side numeric ops: the TNF projection kernel and its numpy projection."""
