"""Data for training and evaluation: the H3.6M pipeline, the batch loader, the GMM keypoint
draw and the synthetic dataset."""
