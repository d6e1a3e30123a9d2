"""Model blocks, backbone and step API of the port."""
