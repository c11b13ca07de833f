"""Dataset builders: triplet TFRecords from image files."""
