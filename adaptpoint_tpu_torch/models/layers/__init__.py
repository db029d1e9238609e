from .blocks import CHANNEL_MAP, ConvBlock, create_act
from .group_layers import (GroupAll, QueryAndGroup, create_grouper,
                           get_aggregation_features)

__all__ = ["CHANNEL_MAP", "ConvBlock", "create_act", "GroupAll",
           "QueryAndGroup", "create_grouper", "get_aggregation_features"]
