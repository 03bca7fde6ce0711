"""Host utilities: the parameter container, weight conversion and the
kernel build."""
