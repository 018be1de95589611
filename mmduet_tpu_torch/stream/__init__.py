from .template import (
    BOS,
    EOS,
    StreamTemplate,
    render_conversation,
    get_learn_ranges,
)
from .tokenizer import StreamTokenizer, CharTokenizer, HFTokenizerAdapter
from .labels import (
    IGNORE_INDEX,
    get_informative_labels,
    get_relevance_labels,
    char_ranges_to_token_labels,
    frame_label_positions,
    scatter_frame_labels,
)
