"""Single-scene tools of the port, each run as a module: the PCA feature
colouring (``visualize_features_pca``) and the scene viewer
(``visualize_scene``)."""
