"""Result writing of the port."""
