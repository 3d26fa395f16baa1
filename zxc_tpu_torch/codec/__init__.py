"""Frame options and the native encoder the port's tests and smoke run use
to make archives."""
