"""One file a kernel, found by the kernel's name (``arith.load_kernel``)."""
