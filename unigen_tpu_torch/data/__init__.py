"""Host-side data (numpy): the image decoder and transforms, the native tar
streamer, and the loaders of the training entries."""
