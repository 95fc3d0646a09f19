"""Data for training and evaluation: the GMM keypoint draw and the synthetic dataset."""
