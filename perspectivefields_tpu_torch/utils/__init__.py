"""Host-side utilities of the port: profiling (``profiling``), and the
field drawings (``draw``, ``visualizer``; matplotlib and cv2 are imported
only by the functions that draw)."""
