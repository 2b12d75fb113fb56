from .replace import (AtrousSeparableConvolution, CheapConvSpec,
                      convert_to_separable_conv, replace_cheap_convs)

__all__ = ["AtrousSeparableConvolution", "CheapConvSpec",
           "convert_to_separable_conv", "replace_cheap_convs"]
