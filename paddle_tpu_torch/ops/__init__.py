"""Operation metadata of the port: the analytic FLOPs counter
(`flops`)."""
