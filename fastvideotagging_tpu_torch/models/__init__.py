"""Models: layers, R(2+1)D, heads, the zoo and the weight bridge."""
