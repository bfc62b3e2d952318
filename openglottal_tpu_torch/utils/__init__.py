"""Weight loading and weight-layout conversion for the port."""
