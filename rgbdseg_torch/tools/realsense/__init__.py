"""Intel RealSense capture utilities (pyrealsense2 only for capture and bag playback)."""
