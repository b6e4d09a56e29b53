"""ReID backbones of the port (OSNet) and their weight loading."""
